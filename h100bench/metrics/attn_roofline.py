"""The attention kernels' share of their roofline, in %: the sum of the
least times of the attention cores they run in the window, over the
device time of the attention family's kernels.

A core's least time (``count.attention_bound_s``) is the largest of its
FLOPs at 989e12 a second, its q, k, v and output read or written once at
3.35e12 bytes a second, and its exponentials at 3.865e12 a second, its
shape from the configuration (the reference's log of cores), not from the
program. The family is the port's flash kernels and the library's fused
attention kernels, by name; K1's projection GEMM is not in it. The cores
they run are the program's kernel route: UNet self-attention of
``SELF_MIN_TOKENS`` tokens or more (gswm_torch.ops.attention's fused-qkv
and flash tiers) and the VAE's attention above ``VAE_MIN_TOKENS`` (the
split kernel). Cross-attention, the text encoders' attention and the
smaller self-attention run as plain matrix products in cuBLAS, whose
kernels no name tells apart from the other GEMMs: neither their time nor
their work is counted.
"""

from h100bench import count

FAMILY = ("flash_hopper_kernel", "flash_narrow_kernel", "flash_mid_kernel",
          "flash_split_kernel", "flash_transposed_kernel", "flash_f32_kernel",
          "flash_fwd", "fmha", "attention_kernel", "sdpa")
SELF_MIN_TOKENS = 256
VAE_MIN_TOKENS = 4096


def kernel_core(core) -> bool:
    kind, _, sq, sk, _, _ = core
    return (kind == "self" and sq >= SELF_MIN_TOKENS) or (kind == "vae" and sq > VAE_MIN_TOKENS)


def read(run, name):
    if run.trace is None:
        return None
    device_s = sum(e - s for n, s, e, _ in run.trace.device_ops
                   if any(f in n.lower() for f in FAMILY))
    if device_s <= 0:
        return None
    _, cores = count.request(run.cell.config, run.cell.mix)
    bound_s = sum(count.attention_bound_s(c) for c in cores if kernel_core(c))
    return 100.0 * run.requests * bound_s / device_s
