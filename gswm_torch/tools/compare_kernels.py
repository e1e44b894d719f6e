"""Time this checkout's kernels against another checkout's, in turns, on one
card.

    python -m gswm_torch.tools.compare_kernels --parent DIR [--out FILE.json]
        [--cases attention,lse,k8,k8f32,k8layouts,k3,f32] [--match TEXT]
        [--require-equal
        [--except-head-dims LO-HI] [--except-transposed LO-HI[:unaligned][,...]]]

DIR is a second checkout of the repository (for example ``git archive`` of
the parent commit unpacked into a git-ignored directory).  Both kernel
libraries are built (each in its own ``build/``) and called through their C
entry points on the same tensors, so nothing but the kernels differs:

  * flash attention at every shape ``chip_smoke.py`` phase 2 gives it whose
    head dim is at most 64 or a multiple of 64: D <= 64 (natural layout, K2
    at D = 40 and flash_hopper.cu's narrow kernel among them, K1's core, the
    split wrapper's ragged shape, packed), the split layout from D = 128 up
    (K4), and the transposed layout (K7), whose ``gswm_flash_transposed``
    each side is called with the arguments its library declares (the head
    dim since K7 takes any, none before: such a side is timed at D = 64
    alone), at S % 8 != 0 too (whatever kernel each side runs there: a
    parent before the hand-loaded boxes runs its masked mma.sync kernel);
    CUDA-event times in the order parent, change, change, parent, and for K7
    the natural layout's kernel of this checkout on the same q, k and v
    (``gswm_flash_split`` on them laid out (B, S, H, D)) in the middle of
    that round, with its output's difference from K7's;
  * fused-qkv self-attention (GEMM + core) at K1's shapes of those widths,
    likewise, and the device time of each side's ``qkv_proj_kernel`` alone
    from ``torch.profiler``; each side's ``gswm_fused_qkv_attn`` is called
    with the arguments its library declares (the head dim since SD 1.x's
    kernels, none before: 64);
  * the host time of one launcher call (tensor-map encoding included) on a
    one-tile shape, where the device never holds the host back;
  * the float32 kernels (``--cases f32``): the projection GEMM at
    ``paths.F32_PROJ_SHAPES`` through each side's ``gswm_qkv_proj_f32`` and
    ``qkv_projection``, then flash attention through each side's
    ``gswm_flash_f32`` (the first design's entry, which this checkout runs
    unsplit) and its wrapper (``flash_attention`` at Sq == Sk,
    ``flash_attention_split`` else: where this checkout's core takes its
    key split) at ``paths.F32_FLASH_SHAPES`` and ``paths.F32_SPLIT_SHAPES``,
    N(0, 1) fp32 inputs (both sides must take every width of the shapes
    chosen: against a checkout whose entry takes d = 64 alone, ``--match ",
    64)"``), the entries in turns and then the wrappers, each side's error
    against float64 printed beside (new arithmetic is not bit-equal to the
    parent's: ``--require-equal`` holds this checkout's within the float32
    bound, 1e-5 of max |want|, instead); then
    this checkout's other forms of csrc/flash_f32.cu against its natural
    one on the same q, k and v, in turns (natural, form, form, natural):
    the pair-packed form at ``paths.F32_PACKED_SHAPES``, the transposed one
    at ``paths.F32_TRANSPOSED_SHAPES`` and ``F32_TRANSPOSED_WORD_SHAPES``
    (and its forced 4-byte copies beside, where S % 4 == 0), the
    log-sum-exp one at ``paths.F32_LSE_SHAPES``;
  * GroupNorm (K8) and ChaCha20 (K3) through each side's own wrappers, host
    side included (their C signatures may differ between the checkouts): K8
    at every GroupNorm shape of the 768x768 path, summed, and at
    ``paths.K8_PROBE_CASES`` with the device time beside; K3's single-key
    keystream at 32 blocks and 2^20, and the many-key keystream bits at
    ``paths.K3_BATCH_SHAPES``, where a side without ``batch_keystream_bits``
    takes what its callers had: ``keystream_bits`` row by row; then this
    checkout's vote kernel (``batch_vote``, ``gswm_chacha20_vote``) against
    the parent's bits-out path for the same function (its
    ``batch_keystream_bits``, or its ``gswm_chacha20_batch`` into a buffer,
    then XOR, ``majority_vote`` and the mean) at ``paths.VOTE_SHAPES`` (the
    scores) and ``paths.VOTE_ROW_SHAPES`` (the voted bits), in turns,
    through the wrappers and through the C entries, with both outputs
    compared (scores as float32, voted bits); and this checkout's embed
    kernel (``batch_embed``, ``gswm_chacha20_embed``) against the parent's
    path for the same latents (its table's bits, XOR with the payload bits,
    ``_bits_to_latent``) at ``paths.EMBED_SHAPES``, likewise, the quantized
    bits equal and z within 4 float32 ulps or 1e-6 relative;
  * GroupNorm beyond the default cases: ``k8f32``, float32 K8 through each
    side's wrapper at the 50 shapes and the probe cases, each side's device
    time beside, this checkout's error against float64, a second call
    bit-equal to the first and the difference from the parent's output;
    ``k8layouts``, this checkout's K8 on channels-last x against the
    parent's on the same x, against this checkout's NCHW kernel on the same
    values and against ``F.group_norm`` on the channels-last x, in turns, in
    both dtypes, with the device times of this checkout's and the parent's
    channels-last kernels and of the NCHW kernel;
  * K7 above d = 160 through both sides' wrappers as well
    (``flash_attention_transposed``: this checkout's one C call, whose
    pre-pass takes its scratch from the stream's pool where S % 8 != 0), in
    turns, outputs compared.

``--match`` keeps only the attention cases whose label holds TEXT (say
``"K2 (4, 4096, 8, "`` for K2 at SD 1.x's level 0 and the narrow widths).
``--require-equal`` fails unless every bf16 attention case's two outputs
are equal bit for bit (a change that must leave the kernels' results
alone), every float32 form's output equals the natural form's, this
checkout's float32 GEMM and core are within the float32 bound of float64,
with ``k8`` among the cases every K8 output equals the parent's (with
``k8f32`` the float32 NCHW outputs too, and within the float32 bound of
float64 and bit-equal from call to call; with ``k8layouts`` the
channels-last outputs within their bounds: bf16 within ``GN_REL_BOUND`` of
max |want| of the fp32 plain version, float32 within the float32 bound of
float64, and bit-equal from call to call), and with
``k3`` K3's single-key words and table bits equal the parent's, the vote
path's scores and voted bits equal the parent's bits-out path's and the
embed's quantized bits the parent's path's (z within 4 ulps);
``--except-head-dims LO-HI`` exempts the cases whose head dim lies in
[LO, HI] (the widths a change hands to a new kernel), whose difference is
printed all the same; ``--except-transposed`` does so for K7's cases alone
where S % 8 == 0, at each range of a comma-separated list, and a range
written ``LO-HI:unaligned`` for K7's cases where S % 8 != 0 (a parent that
ran another kernel there): those at the natural layout's designs (d <= 48,
64 < d <= 512) are then held equal, bit for bit, to the natural layout's
kernel on the same q, k and v instead.

Where the device time goes, apart from the walls above (``torch.profiler``,
the kernels of one call by name):

  * fused-qkv at every K1 shape: each side's GEMM (``qkv_proj_kernel``) and
    attention core (``chip_smoke.py`` phase 2 puts the library's pair beside
    them: this package times no library attention);
  * the split kernel with its log-sum-exp output (``--cases lse``) at
    ``LSE_SHAPES``: both sides in turns, each side's device time with lse
    and without, this checkout's wrapper with ``return_lse`` and without in
    turns, and the host time of the lse's ``torch.empty``;
  * the sd-1-4 UNet forward (``--cases sd14``; 512x512, batch 4 and 8, the
    random weights of ``paths``' seed, 8 heads of 40, 80 and 160) on the
    default route and under switch sets (c) (``paths.TIER_SWITCHES``: K7 at
    level 0) and (t) (``paths.SD14_SWITCHES``: K7 at every level): one
    pipeline, each side's kernel library swapped in under the same modules,
    in turns; the device time a forward (the sum of its kernels' times) and
    its CUDA-event time.

Prints a line per case and, last, one JSON object; ``--out`` also writes it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from gswm_torch import native, roofline
from gswm_torch.tools import paths

ROUNDS = ("parent", "change", "change", "parent")
# K7's cases: the natural layout's kernel on the same q, k and v between
TRANSPOSED_ROUNDS = ("parent", "change", "natural", "natural", "change", "parent")
# the shapes of chip_smoke.py's phase 2 (gswm_torch/tools/paths.py)
FLASH_SHAPES = (  # (label, B, Sq, Sk, H, D)
    *((f"K2 ({b}, {s}, {h}, {d})", b, s, s, h, d) for b, s, h, d in paths.K2_SHAPES),
    *((f"K4 ({b}, {s}, {h}, {d})", b, s, s, h, d) for b, s, h, d in paths.K4_SHAPES),
    *((f"K1 core ({b}, {s}, {h}, {d})", b, s, s, h, d)
      for b, s, _, h, d in paths.K1_SHAPES))
PACKED_SHAPES = tuple((b, s, paths.pairs_of(h))  # (B, S, P)
                      for b, s, h in paths.LEVEL0_SHAPES)
TRANSPOSED_SHAPES = paths.K7_SHAPES  # (B, S, H, D)
K1_SHAPES = paths.K1_SHAPES  # (B, S, C, H, D)
# K4 with its log-sum-exp output (B, S, H, D): phase 12a's full-width shapes
# and their S / LSE_SHARDS query shards, and phase 2's
LSE_SHAPES = (*paths.LSE_SHAPES,
              *((b, s // paths.LSE_SHARDS, h, d) for b, s, h, d in paths.LSE_SHAPES),
              *paths.K4_LSE_SHAPES)


def load_parent(root: Path):
    """The other checkout's kernel library, through its own native.py, and
    its ``ops.groupnorm``, ``core.chacha`` and ``ops.attention`` modules: its package is
    imported under the package's own name while this checkout's modules are
    set aside, then the two are swapped back."""
    def ours():
        return [k for k in sys.modules if k == "gswm_torch" or k.startswith("gswm_torch.")]

    mine = {k: sys.modules.pop(k) for k in ours()}
    sys.path.insert(0, str(root))
    try:
        native_mod = importlib.import_module("gswm_torch.native")
        gn = importlib.import_module("gswm_torch.ops.groupnorm")
        chacha = importlib.import_module("gswm_torch.core.chacha")
        attn = importlib.import_module("gswm_torch.ops.attention")
        if Path(native_mod.__file__).resolve().parent.parent != root:
            raise RuntimeError(f"{root} holds no gswm_torch package")
    finally:
        sys.path.remove(str(root))
        for k in ours():
            del sys.modules[k]
        sys.modules.update(mine)
    return native_mod.library(), gn, chacha, attn


def time_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def in_turns(fns: dict, iters: int, rounds: tuple = ROUNDS) -> dict:
    """{"parent": [ms, ms], "change": [ms, ms]} in the order of ``rounds``."""
    out = {side: [] for side in dict.fromkeys(rounds)}
    for side in rounds:
        out[side].append(time_ms(fns[side], iters))
    return out


def _ranges(text: str) -> list:
    """"LO-HI,LO-HI" -> [(LO, HI), ...]; "" -> []."""
    return [tuple(map(int, part.split("-"))) for part in text.split(",") if part]


def device_times(fn, iters: int, windows: int = 3) -> dict:
    """Device time per call of each kernel ``fn`` launches, by kernel name,
    in ms.  The calls stand well inside the profiler's window, which drops
    a device event that its clock mapping puts a moment outside; a window
    that kept no device event at all (now and then, whatever the kernel) is
    taken again, up to ``windows`` in all."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.05)
        # per kernel name, its mean time by the events that were kept, times
        # its launches a call: the profiler drops some events, so their
        # count, not iters, divides the sum
        times = {e.key: e.self_device_time_total / e.count * max(1, round(e.count / iters)) / 1e3
                 for e in prof.key_averages()
                 if e.device_type.name == "CUDA" and e.self_device_time_total > 0}
        if times:
            break
    return times


def device_ms(fn, iters: int, name_part: str = "") -> float:
    """Device time per call of the kernels whose name holds ``name_part``
    (every kernel of ``fn`` by default), in ms."""
    times = [ms for name, ms in device_times(fn, iters).items() if name_part in name]
    if not times:
        raise RuntimeError(f"the profiler saw no device time for {name_part!r}")
    return sum(times)


def host_us(fn, calls: int = 2000) -> float:
    """Host time of one call, the device never behind by more than a few
    one-tile kernels."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def _sides_ms(fns: dict, iters: int) -> dict:
    t = in_turns(fns, iters)
    t["ratio"] = sum(t["parent"]) / sum(t["change"])
    return t


def groupnorm_shapes() -> list:
    """Every (shape, eps, act) of the 768x768 path's GroupNorms, from the
    sd-2-1 pipeline's hooks (the pipeline freed after)."""
    pipe = paths.build_pipeline("sd-2-1")
    gn_cases = paths.groupnorm_cases(pipe)
    del pipe
    torch.cuda.empty_cache()
    return gn_cases


def _group_norm_f64(x, w, b, eps: float, act) -> torch.Tensor:
    """32-group GroupNorm (+ SiLU) of (B, C, ...) x in float64, the JAX op's
    formulas, whatever x's layout."""
    xd = x.double().reshape(x.shape[0], 32, -1)
    mean = xd.mean(dim=-1, keepdim=True)
    var = (xd.square().mean(dim=-1, keepdim=True) - mean.square()).clamp(min=0.0)
    bcast = (1, x.shape[1]) + (1,) * (x.dim() - 2)
    y = ((xd - mean) * torch.rsqrt(var + eps)).reshape(x.shape) * w.double().reshape(bcast) \
        + b.double().reshape(bcast)
    return y * torch.sigmoid(y) if act == "silu" else y


def compare_group_norm_f32(parent_gn, gn_cases, iters: int) -> dict:
    """float32 NCHW K8 through each side's wrapper in turns at every
    GroupNorm shape of the 768x768 path and at ``paths.K8_PROBE_CASES``,
    each side's device time (the profiler, its kernels of one call) beside,
    this checkout's error against float64 and its second call's output
    against its first."""
    from gswm_torch.ops import groupnorm as gn

    sides = {"parent": parent_gn.fused_group_norm, "change": gn.fused_group_norm}
    g = torch.Generator(device="cuda").manual_seed(18)
    out = {"cases": []}
    sums = {"parent": [0.0, 0.0], "change": [0.0, 0.0]}
    device_sums = {"parent": 0.0, "change": 0.0}
    bound_sum = 0.0
    cases = [(shape, eps, act, False) for shape, eps, act in gn_cases] + \
        [(shape, 1e-6, act, True) for shape, act in paths.K8_PROBE_CASES]
    for shape, eps, act, probe in cases:
        x = torch.randn(shape, generator=g, device="cuda") * 2 + 0.5
        w = 1 + 0.05 * torch.randn(shape[1], generator=g, device="cuda")
        b = 0.05 * torch.randn(shape[1], generator=g, device="cuda")
        fns = {side: (lambda fn=fn: fn(x, w, b, 32, eps, act)) for side, fn in sides.items()}
        t = _sides_ms(fns, iters)
        device = {side: device_ms(fns[side], iters, "gn_") for side in sides}
        got = fns["change"]()
        same = torch.equal(got, fns["change"]())
        parent_diff = (fns["parent"]() - got).abs().max().item()
        want = _group_norm_f64(x, w, b, eps, act)
        rel = ((got.double() - want).abs().max() / want.abs().max()).item()
        del want
        bound, _ = roofline.bound_ms(*roofline.group_norm_cost(shape, roofline.F32),
                                     roofline.PEAK_FP32)
        if not probe:
            bound_sum += bound
            for side in sums:
                sums[side] = [a + c for a, c in zip(sums[side], t[side])]
                device_sums[side] += device[side]
        print(f"K8 fp32 {'probe ' if probe else ''}{shape} {act}: wrapper parent "
              f"{t['parent']} change {t['change']} ms, {t['ratio']:.2f}x; device parent "
              f"{device['parent']:.4f} change {device['change']:.4f} ms; bound {bound:.4f} "
              f"ms; err/max|want| {rel:.2e}; repeats bit for bit {same}; max|parent - "
              f"change| {parent_diff:.3g}", flush=True)
        out["cases"].append(dict(shape=list(shape), eps=eps, act=act, probe=probe, **t,
                                 device_ms=device, bound_ms=bound, change_rel_err=rel,
                                 repeats=same, max_abs_diff=parent_diff))
        del x, got
    out["sum"] = dict(**sums, ratio=sum(sums["parent"]) / sum(sums["change"]),
                      device_ms=device_sums, bound_ms=bound_sum, shapes=len(gn_cases))
    print(f"K8 fp32 {len(gn_cases)} shapes summed: wrapper parent {sums['parent']} change "
          f"{sums['change']} ms, {out['sum']['ratio']:.2f}x; device parent "
          f"{device_sums['parent']:.4f} change {device_sums['change']:.4f} ms; bound "
          f"{bound_sum:.4f} ms", flush=True)
    return out


def compare_group_norm_layouts(parent_gn, gn_cases, iters: int) -> dict:
    """This checkout's K8 on channels-last x against the parent's on the
    same x, against this checkout's NCHW kernel on the same values and
    against the library call on the channels-last x (``F.group_norm`` +
    ``F.silu``, whose time holds PyTorch's own layout copies), in turns
    (parent, NCHW, NHWC, library, library, NHWC, NCHW, parent), bf16 and
    float32, at every GroupNorm shape of the 768x768 path and at
    ``paths.K8_PROBE_CASES``; each output's error (bf16 against the fp32
    plain version, float32 against float64), a second call's output against
    the first, and the device times of the NHWC kernels of both sides and of
    the NCHW kernel."""
    import torch.nn.functional as F

    from gswm_torch.ops import groupnorm as gn

    g = torch.Generator(device="cuda").manual_seed(28)
    turns = ("parent", "nchw", "nhwc", "library", "library", "nhwc", "nchw", "parent")
    timed = ("parent", "nhwc", "nchw")
    out = {"nhwc": []}
    cases = [(shape, eps, act, False) for shape, eps, act in gn_cases] + \
        [(shape, 1e-6, act, True) for shape, act in paths.K8_PROBE_CASES]
    for dtype, elem in ((torch.bfloat16, roofline.BF16), (torch.float32, roofline.F32)):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        sums = {side: 0.0 for side in dict.fromkeys(turns)}
        device_sums = {side: 0.0 for side in timed}
        bound_sum = 0.0
        for shape, eps, act, probe in cases:
            x = (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5).to(dtype)
            xl = x.contiguous(memory_format=torch.channels_last)
            w = 1 + 0.05 * torch.randn(shape[1], generator=g, device="cuda")
            b = 0.05 * torch.randn(shape[1], generator=g, device="cuda")
            wl, bl = w.to(dtype), b.to(dtype)

            def library(xl=xl, wl=wl, bl=bl, eps=eps, act=act):
                y = F.group_norm(xl, 32, wl, bl, eps)
                return F.silu(y) if act == "silu" else y

            fns = {"parent": lambda xl=xl, w=w, b=b, eps=eps, act=act:
                       parent_gn.fused_group_norm(xl, w, b, 32, eps, act),
                   "nchw": lambda x=x, w=w, b=b, eps=eps, act=act: gn.fused_group_norm(
                       x, w, b, 32, eps, act),
                   "nhwc": lambda xl=xl, w=w, b=b, eps=eps, act=act: gn.fused_group_norm(
                       xl, w, b, 32, eps, act),
                   "library": library}
            t = in_turns(fns, iters, turns)
            device = {side: device_ms(fns[side], iters, "gn_") for side in timed}
            got = fns["nhwc"]()
            repeats = torch.equal(got, fns["nhwc"]())
            layout_kept = got.is_contiguous(memory_format=torch.channels_last)
            want = gn.fused_group_norm_reference(x.float(), w, b, 32, eps, act) \
                if dtype == torch.bfloat16 else _group_norm_f64(x, w, b, eps, act)
            top = want.abs().max().item()
            err = (got.to(want.dtype) - want).abs().max().item()
            parent_err = (fns["parent"]().to(want.dtype) - want).abs().max().item()
            nchw_err = (fns["nchw"]().to(want.dtype) - want).abs().max().item()
            lib_err = (library().to(want.dtype) - want).abs().max().item()
            del want
            bound, _ = roofline.bound_ms(*roofline.group_norm_cost(shape, elem),
                                         roofline.PEAK_FP32)
            med = {side: statistics.median(v) for side, v in t.items()}
            host = {side: host_us(fns[side], 200) for side in ("nchw", "nhwc")} if probe \
                else None
            if probe:
                print(f"K8 {tag} probe {shape}: host time a call, NCHW {host['nchw']:.1f} us, "
                      f"NHWC {host['nhwc']:.1f} us", flush=True)
            if not probe:
                bound_sum += bound
                for side in sums:
                    sums[side] += med[side]
                for side in timed:
                    device_sums[side] += device[side]
            print(f"K8 {tag} {'probe ' if probe else ''}{shape} {act}: NHWC {t['nhwc']} "
                  f"(device {device['nhwc']:.4f}), parent's NHWC {t['parent']} (device "
                  f"{device['parent']:.4f}), NCHW {t['nchw']} (device {device['nchw']:.4f}), "
                  f"library on channels_last {t['library']} ms; bound {bound:.4f} ms; "
                  f"err/max|want| NHWC {err / top:.2e}, parent's {parent_err / top:.2e}, "
                  f"NCHW {nchw_err / top:.2e}, library {lib_err / top:.2e}; repeats "
                  f"{repeats}; output channels_last {layout_kept}", flush=True)
            out["nhwc"].append(dict(dtype=tag, shape=list(shape), eps=eps, act=act,
                                    probe=probe, **t, device_ms=device, host_us=host,
                                    bound_ms=bound, err=err, parent_err=parent_err,
                                    nchw_err=nchw_err, library_err=lib_err, max_want=top,
                                    repeats=repeats, channels_last=layout_kept))
            del x, xl, got
        out[f"{tag}_sum"] = dict(median_ms=sums, device_ms=device_sums, bound_ms=bound_sum,
                                 shapes=len(gn_cases))
        print(f"K8 {tag} {len(gn_cases)} shapes summed (medians): NHWC {sums['nhwc']:.4f} "
              f"(device {device_sums['nhwc']:.4f}), parent's NHWC {sums['parent']:.4f} "
              f"(device {device_sums['parent']:.4f}), NCHW {sums['nchw']:.4f} (device "
              f"{device_sums['nchw']:.4f}), library {sums['library']:.4f} ms; bound "
              f"{bound_sum:.4f} ms", flush=True)
    return out


def compare_group_norm(parent_gn, iters: int, gn_cases=None) -> dict:
    """K8 through each side's wrapper, fp32 parameters on the card: every
    GroupNorm shape of the 768x768 path (the sum is per round), then the
    probe cases with each side's device time."""
    from gswm_torch.ops import groupnorm as gn

    sides = {"parent": parent_gn.fused_group_norm, "change": gn.fused_group_norm}
    if gn_cases is None:
        gn_cases = groupnorm_shapes()
    g = torch.Generator(device="cuda").manual_seed(8)
    out = {"cases": [], "probes": []}
    sums = {"parent": [0.0, 0.0], "change": [0.0, 0.0]}
    bound_sum = 0.0
    for shape, eps, act in gn_cases:
        x = (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5).bfloat16()
        w = 1 + 0.05 * torch.randn(shape[1], generator=g, device="cuda")
        b = 0.05 * torch.randn(shape[1], generator=g, device="cuda")
        t = _sides_ms({side: (lambda fn=fn: fn(x, w, b, 32, eps, act))
                       for side, fn in sides.items()}, iters)
        diff = (sides["parent"](x, w, b, 32, eps, act).float()
                - sides["change"](x, w, b, 32, eps, act).float()).abs().max().item()
        bound, _ = roofline.bound_ms(*roofline.group_norm_cost(shape), roofline.PEAK_FP32)
        bound_sum += bound
        for side in sums:
            sums[side] = [a + c for a, c in zip(sums[side], t[side])]
        print(f"K8 {shape} {act}: parent {t['parent']} change {t['change']} ms, "
              f"{t['ratio']:.2f}x, bound {bound:.4f} ms, max|parent - change| {diff:.5f}",
              flush=True)
        out["cases"].append(dict(shape=list(shape), eps=eps, act=act, **t,
                                 bound_ms=bound, max_abs_diff=diff))
        del x
    out["sum"] = dict(**sums, ratio=sum(sums["parent"]) / sum(sums["change"]),
                      bound_ms=bound_sum, shapes=len(gn_cases))
    print(f"K8 {len(gn_cases)} shapes summed: parent {sums['parent']} change "
          f"{sums['change']} ms, {out['sum']['ratio']:.2f}x, bound {bound_sum:.4f} ms",
          flush=True)
    for shape, act in paths.K8_PROBE_CASES:
        x = (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5).bfloat16()
        w, b = torch.ones(shape[1], device="cuda"), torch.zeros(shape[1], device="cuda")
        fns = {side: (lambda fn=fn: fn(x, w, b, 32, 1e-5, act))
               for side, fn in sides.items()}
        t = _sides_ms(fns, 50)
        device = {side: [] for side in sides}
        for side in ROUNDS:
            device[side].append(device_ms(fns[side], 50, "gn_"))
        bound, _ = roofline.bound_ms(*roofline.group_norm_cost(shape), roofline.PEAK_FP32)
        # what a plain copy of x takes: the same bytes read and written
        y = torch.empty_like(x)
        copy = time_ms(lambda: y.copy_(x), 50)
        print(f"K8 probe {shape} {act}: wrapper parent {t['parent']} change "
              f"{t['change']} ms, {t['ratio']:.2f}x; device parent {device['parent']} "
              f"change {device['change']} ms; bound {bound:.4f} ms; Tensor.copy_ of x "
              f"{copy:.4f} ms", flush=True)
        out["probes"].append(dict(shape=list(shape), act=act, **t, device_ms=device,
                                  bound_ms=bound, copy_ms=copy))
        del y
        del x
    return out


def compare_chacha(libs: dict, parent_chacha, stream: int, iters: int) -> dict:
    """K3 through each side's wrappers: one key, and a table of keys; then
    the vote path against the parent's bits-out path."""
    from gswm_torch.core import chacha

    sides = {"parent": parent_chacha, "change": chacha}
    key, nonce = bytes.fromhex(paths.KEY_HEX), bytes.fromhex(paths.NONCE_HEX)
    out = {"single": [], "batch": []}
    for n_blocks in (32, 2**20):
        fns = {side: (lambda m=m: m.keystream_words(key, nonce, n_blocks, "cuda"))
               for side, m in sides.items()}
        same = torch.equal(fns["parent"](), fns["change"]())
        t = _sides_ms(fns, iters)
        bound, _ = roofline.bound_ms(*roofline.chacha_cost(n_blocks), roofline.PEAK_INT32)
        print(f"K3 one key, {n_blocks} blocks: parent {t['parent']} change {t['change']} "
              f"ms, {t['ratio']:.2f}x, bound {bound:.6f} ms, equal words {same}", flush=True)
        out["single"].append(dict(label=f"K3 one key, {n_blocks} blocks", n_blocks=n_blocks,
                                  **t, bound_ms=bound, equal=same))
    for rows, n_blocks in paths.K3_BATCH_SHAPES:
        n_bits = n_blocks * chacha.BLOCK_BITS
        keys, nonces, _, _ = paths.multikey_material(rows, seed=rows)

        def row_by_row(m):
            return torch.stack([m.keystream_bits(k, n, n_bits, "cuda")
                                for k, n in zip(keys, nonces)])

        fns = {side: ((lambda m=m: m.batch_keystream_bits(keys, nonces, n_bits, "cuda"))
                      if hasattr(m, "batch_keystream_bits") else (lambda m=m: row_by_row(m)))
               for side, m in sides.items()}
        how = {side: "one launch" if hasattr(m, "batch_keystream_bits") else "row by row"
               for side, m in sides.items()}
        same = torch.equal(fns["parent"](), fns["change"]())
        # a side that loops over the rows takes seconds a call at 10,000 rows
        t = _sides_ms(fns, iters if rows <= 64 else 2)
        bound, _ = roofline.bound_ms(*roofline.chacha_batch_cost(rows, n_bits),
                                     roofline.PEAK_INT32)
        device = device_ms(fns["change"], 10, "chacha20_batch")
        # what filling the output takes: the same bytes written
        bits = torch.empty((rows, n_bits), dtype=torch.uint8, device="cuda")
        fill = time_ms(lambda: bits.fill_(1), 50)
        print(f"K3 {rows} keys x {n_blocks} blocks, bits out: parent ({how['parent']}) "
              f"{t['parent']} change ({how['change']}) {t['change']} ms, "
              f"{t['ratio']:.1f}x, on the device {device:.4f} ms, bound {bound:.6f} ms, "
              f"Tensor.fill_ of the output {fill:.4f} ms, equal bits {same}", flush=True)
        if not same:
            raise AssertionError(f"K3 over {rows} keys: the two sides' bits differ")
        out["batch"].append(dict(label=f"K3 {rows} keys x {n_blocks} blocks", rows=rows,
                                 n_blocks=n_blocks, how=how, **t, device_ms=device,
                                 bound_ms=bound, fill_ms=fill, equal=same))
        del bits
    out["vote"] = compare_vote(libs, parent_chacha, stream, iters)
    out["embed"] = compare_embed(libs, parent_chacha, stream, iters)
    return out


EMBED_ULPS, EMBED_REL = 4, 1e-6  # the embed kernel's z against the plain version's


def compare_embed(libs: dict, parent_chacha, stream: int, iters: int) -> list:
    """This checkout's embed kernel (``batch_embed``, ``gswm_chacha20_embed``)
    against the parent's path for the same latents (its
    ``batch_keystream_bits``, or its ``gswm_chacha20_batch`` into a buffer,
    then XOR with the payload bits on the card and ``_bits_to_latent``) at
    ``paths.EMBED_SHAPES``, in turns, through the wrappers and the C
    entries: every quantized bit equal, z within EMBED_ULPS float32 ulps or
    EMBED_REL relative of the parent's (whose ndtri is
    torch.special.ndtri's)."""
    import numpy as np

    from gswm_torch.core import bits as bitops
    from gswm_torch.core import chacha, multikey
    from gswm_torch.core.decode import quantize_latent_bits
    from gswm_torch.core.embed import _bits_to_latent

    out = []
    for rows, elements, l in paths.EMBED_SHAPES:
        n_bits = elements * l
        keys, nonces, msgs, _ = paths.multikey_material(rows, seed=rows + l)
        payload = np.stack([bitops.diffuse_payload(bitops.bytes_to_bits(m), n_bits)
                            for m in msgs])
        u = torch.rand((rows, elements), generator=torch.Generator(device="cuda").manual_seed(
            rows + l), device="cuda")
        table, words = multikey._table_and_payload(keys, nonces, msgs, n_bits, "cuda")
        payload_dev = torch.from_numpy(payload).to("cuda")
        bits_buf = torch.empty((rows, n_bits), dtype=torch.uint8, device="cuda")
        z = torch.empty_like(u)

        def finish(ks):
            return _bits_to_latent(ks.bitwise_xor_(payload_dev).reshape(-1), u.reshape(-1), l,
                                   (rows, elements))

        fns = {"wrapper": {
            "parent": lambda: finish(parent_chacha.batch_keystream_bits(keys, nonces, n_bits,
                                                                        "cuda")),
            "change": lambda: chacha.batch_embed(table, words, u, l)}}

        def parent_entry():
            libs["parent"].call("gswm_chacha20_batch", table.data_ptr(), bits_buf.data_ptr(),
                                rows, n_bits, stream)
            return finish(bits_buf)

        def change_entry():
            libs["change"].call("gswm_chacha20_embed", table.data_ptr(), words.data_ptr(),
                                u.data_ptr(), z.data_ptr(), rows, elements, l, stream)
            return z

        fns["entry"] = {"parent": parent_entry, "change": change_entry}
        want = fns["wrapper"]["parent"]()
        q4 = (rows, 1, 1, elements)
        bits_want = quantize_latent_bits(want.view(q4), l)
        equal, ulps = True, 0
        for fn in (fns["entry"]["parent"], fns["wrapper"]["change"], change_entry):
            got = fn()
            ulp = (got.view(torch.int32).long() - want.view(torch.int32).long()).abs()
            close = (ulp <= EMBED_ULPS) | ((got - want).abs() <= EMBED_REL * want.abs())
            equal &= bool(close.all()) and torch.equal(quantize_latent_bits(got.view(q4), l),
                                                       bits_want)
            ulps = max(ulps, int(ulp.max()))
        t_wrap = _sides_ms(fns["wrapper"], iters)
        t_entry = _sides_ms(fns["entry"], iters)
        device = {"parent": sum(device_times(parent_entry, 10).values()),
                  "change": device_ms(change_entry, 10, "chacha20_embed")}
        bound, roof = roofline.bound_ms(*roofline.chacha_embed_cost(rows, elements, l),
                                        roofline.PEAK_INT32)
        label = f"K3 embed ({rows}, {elements}, l = {l})"
        print(f"{label}: wrapper parent {t_wrap['parent']} change {t_wrap['change']} ms, "
              f"{t_wrap['ratio']:.1f}x; C entry parent {t_entry['parent']} change "
              f"{t_entry['change']} ms, {t_entry['ratio']:.1f}x; device parent "
              f"{device['parent']:.4f} change {device['change']:.4f} ms; bound {bound:.6f} ms "
              f"by {roof} ({bound / device['change']:.1%} of the change's device time); "
              f"quantized bits equal and z within {ulps} ulps of the parent's: {equal}",
              flush=True)
        out.append(dict(label=label, shape=[rows, elements, l], wrapper=t_wrap, entry=t_entry,
                        device_ms=device, bound_ms=bound, max_ulps=ulps, equal=equal))
        del table, words, u, payload_dev, bits_buf, z, want, bits_want
    return out


def compare_vote(libs: dict, parent_chacha, stream: int, iters: int) -> list:
    """This checkout's vote kernel against the parent's bits-out path for the
    same function, in turns, through the wrappers and the C entries; the
    scores (``paths.VOTE_SHAPES``, one latent for every row) or the voted
    bits (``VOTE_ROW_SHAPES``, a latent row a key) are timed, and both
    outputs compared."""
    from gswm_torch.core import chacha
    from gswm_torch.core.decode import majority_vote

    cases = [(*shape, True) for shape in paths.VOTE_SHAPES] + \
        [(*shape, False) for shape in paths.VOTE_ROW_SHAPES]
    out = []
    for rows, n_bits, mb, shared in cases:
        case = paths.vote_material(rows, n_bits, mb, shared)
        bits_buf = torch.empty((rows, n_bits), dtype=torch.uint8, device="cuda")

        def finish(ks, scores):
            voted = majority_vote(ks.bitwise_xor_(case.bits), mb)
            return (voted == case.message).to(torch.float32).mean(dim=-1) if scores else voted

        def parent_wrapper(scores=shared):
            return finish(parent_chacha.batch_keystream_bits(case.keys, case.nonces, n_bits,
                                                             "cuda"), scores)

        def parent_entry(scores=shared):
            libs["parent"].call("gswm_chacha20_batch", case.table.data_ptr(),
                                bits_buf.data_ptr(), rows, n_bits, stream)
            return finish(bits_buf, scores)

        def change_wrapper(scores=shared):
            return chacha.batch_vote(case.table, case.words, n_bits, mb,
                                     case.expected if scores else None)

        outs = {True: torch.empty(rows, dtype=torch.float32, device="cuda"),
                False: torch.empty((rows, mb), dtype=torch.uint8, device="cuda")}

        def change_entry(scores=shared):
            libs["change"].call("gswm_chacha20_vote", case.table.data_ptr(),
                                case.words.data_ptr(), case.words.shape[0],
                                case.expected.data_ptr() if scores else None,
                                outs[True].data_ptr() if scores else None,
                                None if scores else outs[False].data_ptr(),
                                rows, n_bits, mb, stream)
            return outs[scores]

        equal = {}
        for what, scores in (("scores", True), ("voted bits", False)):
            want = parent_wrapper(scores).clone()
            equal[what] = all(torch.equal(fn(scores), want) for fn in
                              (parent_entry, change_wrapper, change_entry))
        t_wrap = _sides_ms({"parent": parent_wrapper, "change": change_wrapper}, iters)
        t_entry = _sides_ms({"parent": parent_entry, "change": change_entry}, iters)
        device = {"parent": sum(device_times(parent_entry, 10).values()),
                  "change": device_ms(change_entry, 10, "chacha20_vote")}
        bound, roof = roofline.bound_ms(*roofline.chacha_vote_cost(rows, n_bits, mb, shared,
                                                                   shared),
                                        roofline.PEAK_INT32)
        label = (f"K3 vote ({rows}, {n_bits}, {mb}, "
                 f"{'one latent' if shared else 'a latent a row'})")
        print(f"{label}, {'scores' if shared else 'voted bits'} timed: wrapper parent "
              f"{t_wrap['parent']} change {t_wrap['change']} ms, {t_wrap['ratio']:.1f}x; C "
              f"entry parent {t_entry['parent']} change {t_entry['change']} ms, "
              f"{t_entry['ratio']:.1f}x; device parent {device['parent']:.4f} change "
              f"{device['change']:.4f} ms; bound {bound:.6f} ms by {roof}; equal to the "
              f"parent's {equal}", flush=True)
        out.append(dict(label=label, shape=[rows, n_bits, mb], shared=shared,
                        wrapper=t_wrap, entry=t_entry, device_ms=device, bound_ms=bound,
                        equal=all(equal.values()), equal_by_output=equal))
        del bits_buf, case
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cases", default="attention,lse,k8,k3,f32",
                    help="which of attention, lse, k8, k8f32, k8layouts, k3, f32, "
                         "sd14 to time "
                         "(comma-separated)")
    ap.add_argument("--match", default="",
                    help="time only the attention cases whose label holds this")
    ap.add_argument("--require-equal", action="store_true",
                    help="fail unless every attention output equals the parent's")
    ap.add_argument("--except-head-dims", default="",
                    help="LO-HI: --require-equal skips the cases at these head dims")
    ap.add_argument("--except-transposed", default="",
                    help="LO-HI[:unaligned][,...]: --require-equal skips K7's S %% 8 == 0 "
                         "cases (S %% 8 != 0 with :unaligned, held to the natural layout's "
                         "kernel at its designs instead) at these head dims")
    args = ap.parse_args()
    cases = set(args.cases.split(","))
    lo, hi = map(int, args.except_head_dims.split("-")) if args.except_head_dims \
        else (1, 0)
    if not cases or cases - {"attention", "lse", "k8", "k8f32", "k8layouts", "k3",
                             "f32", "sd14"}:
        raise SystemExit(f"compare_kernels: unknown cases {args.cases!r}")
    if not torch.cuda.is_available():
        raise SystemExit("compare_kernels: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    parent_lib, parent_gn, parent_chacha, parent_attn = load_parent(args.parent.resolve())
    libs = {"parent": parent_lib, "change": native.library()}
    dev = torch.device("cuda")
    stream = native.stream_handle(dev)
    g = torch.Generator(device=dev).manual_seed(4)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).bfloat16()

    result = {"card": card, "rounds": list(ROUNDS)}
    if "sd14" in cases:  # first, while the process and its profiler are young
        result["sd14"] = compare_sd14(libs, args.iters)
    if cases & {"k8", "k8f32", "k8layouts"}:
        gn_cases = groupnorm_shapes()
    if "k8" in cases:
        result["group_norm"] = compare_group_norm(parent_gn, args.iters, gn_cases)
    if "k8f32" in cases:
        result["group_norm_f32"] = compare_group_norm_f32(parent_gn, gn_cases, args.iters)
    if "k8layouts" in cases:
        result["group_norm_layouts"] = compare_group_norm_layouts(parent_gn, gn_cases,
                                                                  args.iters)
    if "k3" in cases:
        result["chacha"] = compare_chacha(libs, parent_chacha, stream, args.iters)
    if "attention" in cases:
        result.update(compare_attention(libs, rand, stream, args.iters, args.match,
                                        parent_attn))
    if "lse" in cases:
        result["lse"] = compare_lse(libs, rand, stream, args.iters, args.match)
    if "f32" in cases:
        result["f32_proj"] = compare_f32_proj(libs, parent_attn, stream, args.iters,
                                              args.match)
        result["f32"] = compare_f32(libs, parent_attn, stream, args.iters, args.match)
        result["f32_forms"] = compare_f32_forms(libs["change"], stream, args.iters,
                                                args.match)
    print(json.dumps(result))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    if args.require_equal:
        parts = [part for part in args.except_transposed.split(",") if part]
        exempt_t = _ranges(",".join(p_ for p_ in parts if not p_.endswith(":unaligned")))
        exempt_u = _ranges(",".join(p_[:-len(":unaligned")] for p_ in parts
                                    if p_.endswith(":unaligned")))

        def exempt(key, case):
            d, aligned = case["head_dim"], case["shape"][1] % 8 == 0
            return key == "transposed" and any(
                a <= d <= b for a, b in (exempt_t if aligned else exempt_u))

        held = [case for key in ("flash", "packed", "transposed", "fused_qkv", "lse")
                for case in result.get(key, []) if not lo <= case["head_dim"] <= hi
                and not exempt(key, case)]
        differ = [case for case in held
                  if case["max_abs_diff"] != 0.0 or case.get("lse_max_abs_diff", 0.0) != 0.0]
        # K7 at S % 8 != 0 on the natural layout's designs: bit-equal to them
        differ += [case for case in result.get("transposed", []) if exempt("transposed", case)
                   and case["shape"][1] % 8 and case["natural_max_abs_diff"] != 0.0
                   and (case["head_dim"] <= 48 or 64 < case["head_dim"])]
        differ += [case for case in result.get("transposed_wrapper", []) if not case["equal"]
                   and not exempt("transposed", case)]
        # the float32 forms: bit-equal to this checkout's natural form
        forms = result.get("f32_forms", [])
        differ += [case for case in forms if case["natural_max_abs_diff"] != 0.0]
        gn_cases = result.get("group_norm", {}).get("cases", [])
        differ += [case for case in gn_cases if case["max_abs_diff"] != 0.0]
        # K3: the single-key words and the table's bits equal the parent's;
        # the vote path's scores and voted bits equal its bits-out path's
        k3 = [case for key in ("single", "batch", "vote", "embed")
              for case in result.get("chacha", {}).get(key, [])]
        differ += [case for case in k3 if not case["equal"]]
        # the float32 GEMM and core: new arithmetic, so no bit-equality with
        # the parent; this checkout's outputs within the float32 bound of
        # float64 instead
        f32 = result.get("f32_proj", []) + result.get("f32", []) + \
            result.get("group_norm_f32", {}).get("cases", [])
        differ += [case for case in f32 if not case["change_rel_err"] <= F32_REL_BOUND]
        differ += [case for case in result.get("group_norm_f32", {}).get("cases", [])
                   if not case["repeats"] or case["max_abs_diff"] != 0.0]
        # channels-last K8: a new design, held to its bounds and to itself
        differ += [case for case in result.get("group_norm_layouts", {}).get("nhwc", [])
                   if not case["repeats"] or not case["channels_last"]
                   or case["err"] > (GN_REL_BOUND if case["dtype"] == "bf16"
                                     else F32_REL_BOUND) * case["max_want"]]
        if differ:
            raise SystemExit(f"compare_kernels: {len(differ)} attention cases differ from "
                             f"the parent's: {[c.get('label', c['shape']) for c in differ]}")
        print(f"all {len(held)} attention outputs held equal the parent's, bit for bit"
              + (f"; {len(forms)} float32 forms equal the natural form's" if forms else "")
              + (f"; {len(gn_cases)} K8 outputs equal the parent's" if gn_cases else "")
              + (f"; {len(k3)} K3 cases equal the parent's (the vote path its bits-out "
                 "path's, the embed's quantized bits and z within 4 ulps)" if k3 else "")
              + (f"; {len(f32)} float32 GEMM and core outputs within {F32_REL_BOUND:g} of "
                 "max |want| against float64" if f32 else "")
              + (f" (head dims {lo}-{hi} exempt)" if lo <= hi else "")
              + (f" (K7 at head dims {args.except_transposed} exempt; at S % 8 != 0 on "
                 "the natural layout's designs held to its kernel instead)"
                 if exempt_t or exempt_u else ""), flush=True)


def compare_attention(libs: dict, rand, stream: int, iters: int, match: str = "",
                      parent_attn=None) -> dict:
    """The flash kernels and K1's GEMM through their C entry points; only
    the cases whose label holds ``match``; with ``parent_attn``, K7 above d
    = 160 through both sides' wrappers too."""
    result = {"flash": [], "packed": [], "transposed": [], "transposed_wrapper": [],
              "fused_qkv": [],
              "host_us": {}}
    for label, b, sq, sk, h, d in FLASH_SHAPES:
        if match not in label:
            continue
        q, k, v = rand(b, sq, h, d), rand(b, sk, h, d), rand(b, sk, h, d)
        outs = {side: torch.empty_like(q) for side in libs}
        fns = {side: (lambda side=side: libs[side].call(
            "gswm_flash_split", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            outs[side].data_ptr(), b, sq, sk, h, d, stream)) for side in libs}
        t = in_turns(fns, iters)
        diff = (outs["parent"].float() - outs["change"].float()).abs().max().item()
        bound, roof = roofline.attention_bound_ms(roofline.attention_cost(b, sq, sk, h, d))
        ratio = sum(t["parent"]) / sum(t["change"])
        print(f"flash {label}: parent {t['parent']} change {t['change']} ms, "
              f"{ratio:.2f}x, bound {bound:.4f} ms by {roof}, max|parent - change| "
              f"{diff:.5f}", flush=True)
        result["flash"].append(dict(label=label, shape=[b, sq, sk, h, d], head_dim=d, **t,
                                    ratio=ratio, bound_ms=bound, roof=roof,
                                    max_abs_diff=diff))
    for b, s, pairs in PACKED_SHAPES:
        if match not in f"packed (B={b}, S={s}, P={pairs})":
            continue
        qkv = rand(b, s, 3 * pairs * 128)
        outs = {side: qkv.new_empty((b, s, pairs * 128)) for side in libs}
        fns = {side: (lambda side=side: libs[side].call(
            "gswm_flash_packed", qkv.data_ptr(), outs[side].data_ptr(), b, s, pairs,
            stream)) for side in libs}
        t = in_turns(fns, iters)
        diff = (outs["parent"].float() - outs["change"].float()).abs().max().item()
        ratio = sum(t["parent"]) / sum(t["change"])
        print(f"packed (B={b}, S={s}, P={pairs}): parent {t['parent']} change "
              f"{t['change']} ms, {ratio:.2f}x, max|parent - change| {diff:.5f}",
              flush=True)
        result["packed"].append(dict(shape=[b, s, pairs], head_dim=64, **t, ratio=ratio,
                                     max_abs_diff=diff))
    # (B, S, H[, D]): a library built before K7 took the head dim declares
    # one int fewer and takes D = 64 alone
    takes_d = {side: len(libs[side].lib.gswm_flash_transposed.argtypes) == 7
               for side in libs}
    for b, s, h, d in TRANSPOSED_SHAPES:
        if match not in f"transposed (B={b}, S={s}, H={h}, D={d})":
            continue
        if d != 64 and not all(takes_d.values()):
            print(f"transposed (B={b}, S={s}, H={h}, D={d}): skipped, a side takes "
                  "D = 64 alone", flush=True)
            continue
        qkv_t = rand(3 * h * d, b, s)
        outs = {side: qkv_t.new_empty((h * d, b, s)) for side in libs}
        fns = {side: (lambda side=side: libs[side].call(
            "gswm_flash_transposed", qkv_t.data_ptr(), outs[side].data_ptr(), b, s, h,
            *((d,) if takes_d[side] else ()), stream)) for side in libs}
        # the same q, k and v laid out (B, S, H, D), through this checkout's
        # natural-layout launcher
        q, k, v = (t_.permute(2, 3, 0, 1).contiguous() for t_ in qkv_t.view(3, h, d, b, s))
        nat = torch.empty_like(q)
        fns["natural"] = lambda: libs["change"].call(
            "gswm_flash_split", q.data_ptr(), k.data_ptr(), v.data_ptr(), nat.data_ptr(), b,
            s, s, h, d, stream)
        t = in_turns(fns, iters, TRANSPOSED_ROUNDS)
        diff = (outs["parent"].float() - outs["change"].float()).abs().max().item()
        nat_diff = (nat.permute(2, 3, 0, 1).reshape(h * d, b, s).float()
                    - outs["change"].float()).abs().max().item()
        bound, roof = roofline.attention_bound_ms(roofline.attention_cost(b, s, s, h, d))
        ratio = sum(t["parent"]) / sum(t["change"])
        print(f"transposed (B={b}, S={s}, H={h}, D={d}): parent {t['parent']} change "
              f"{t['change']} ms, {ratio:.2f}x, natural layout {t['natural']} ms, bound "
              f"{bound:.4f} ms by {roof}, max|parent - change| {diff:.5f}, "
              f"max|natural - change| {nat_diff:.5f}", flush=True)
        result["transposed"].append(dict(shape=[b, s, h, d], head_dim=d, **t, ratio=ratio,
                                         bound_ms=bound, roof=roof, max_abs_diff=diff,
                                         natural_max_abs_diff=nat_diff))
        if parent_attn is not None and d > 160:
            # the wrappers: this checkout's one C call (the pre-pass's scratch
            # from the stream's pool where S % 8 != 0)
            from gswm_torch.ops import attention as attn

            wrappers = {"parent": lambda: parent_attn.flash_attention_transposed(qkv_t, h),
                        "change": lambda: attn.flash_attention_transposed(qkv_t, h)}
            same = torch.equal(wrappers["parent"](), wrappers["change"]())
            tw = in_turns(wrappers, iters)
            print(f"transposed wrapper (B={b}, S={s}, H={h}, D={d}): parent {tw['parent']} "
                  f"change {tw['change']} ms, {sum(tw['parent']) / sum(tw['change']):.2f}x, "
                  f"equal {same}", flush=True)
            result["transposed_wrapper"].append(dict(shape=[b, s, h, d], head_dim=d, **tw,
                                                     equal=same))
    for b, s, c, h, d in K1_SHAPES:
        label = f"fused_qkv (B={b}, S={s}, C={c}, H={h}, D={d})"
        if match not in label:
            continue
        n = h * d
        x = rand(b, s, c)
        ws = [rand(n, c, scale=c**-0.5) for _ in range(3)]
        bufs = {side: [x.new_empty((b, s, n)) for _ in range(4)] for side in libs}
        # (B, S, C, H[, D]): a library built before the head dim was an
        # argument declares one int fewer
        dims = {side: (b, s, c, h, d)[:len(libs[side].lib.gswm_fused_qkv_attn.argtypes) - 9]
                for side in libs}
        if d != 64 and any(len(dm) < 5 for dm in dims.values()):
            print(f"{label}: skipped, a side takes D = 64 alone", flush=True)
            continue
        fns = {side: (lambda side=side: libs[side].call(
            "gswm_fused_qkv_attn", x.data_ptr(), *(w.data_ptr() for w in ws),
            *(t.data_ptr() for t in bufs[side]), *dims[side], stream)) for side in libs}
        t = in_turns(fns, iters)
        # device time a call: the GEMM, and the rest (the attention core)
        gemm = {side: [] for side in libs}
        core = {side: [] for side in libs}
        for side in ROUNDS:
            times = device_times(fns[side], iters)
            g = sum(ms for name, ms in times.items() if "qkv_proj_kernel" in name)
            gemm[side].append(g)
            core[side].append(sum(times.values()) - g)
        diff = (bufs["parent"][3].float() - bufs["change"][3].float()).abs().max().item()
        bound, _ = roofline.bound_ms(*roofline.projection_cost(b * s, c, n),
                                     roofline.PEAK_BF16)
        core_bound, core_roof = roofline.attention_bound_ms(
            roofline.attention_cost(b, s, s, h, d))
        print(f"{label}: parent {t['parent']} change {t['change']} ms; device a call: "
              f"GEMM parent {gemm['parent']} change {gemm['change']} ms (bound "
              f"{bound:.4f}), core parent {core['parent']} change {core['change']} ms "
              f"(bound {core_bound:.4f} by {core_roof}); max|parent - change| "
              f"{diff:.5f}", flush=True)
        result["fused_qkv"].append(dict(
            label=label, shape=[b, s, c, h, d], head_dim=d, **t, gemm_device_ms=gemm,
            gemm_bound_ms=bound, core_device_ms=core, core_bound_ms=core_bound,
            max_abs_diff=diff))
    # one 64-row, one 128-key tile: the launcher's host time
    q, k, v = (rand(1, 64, 1, 64) for _ in range(3))
    out = torch.empty_like(q)
    for side in ROUNDS:
        us = host_us(lambda side=side: libs[side].call(
            "gswm_flash_split", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            1, 64, 64, 1, 64, stream))
        result["host_us"].setdefault(side, []).append(us)
    print(f"host time per flash launcher call, us: {result['host_us']}", flush=True)
    return result


# the float32 bound: a float32 kernel's largest error against float64, over
# the largest |want| (chip_smoke.py F32_REL_BOUND)
F32_REL_BOUND = 1e-5
# bf16 K8 against its fp32 plain version, of the largest |want|
# (chip_smoke.py GN_REL_BOUND)
GN_REL_BOUND = 0.01
# the float32 cases' rounds: each side's C entry in turns, then each side's
# wrapper (where this checkout's core takes its key split) in turns
F32_ROUNDS = ("parent", "change", "change", "parent")


def _rel_err(got, want) -> float:
    return ((got.double() - want).abs().max() / want.abs().max()).item()


def _f32_sides(label: str, entries: dict, wrappers: dict, outs: dict, want, iters: int,
               bound: tuple) -> dict:
    """Time both sides' C entries (writing ``outs``: a tensor, or q, k and v
    to be joined) and both sides' wrappers in turns, each side's error
    against float64 ``want``; print and return the case."""
    t = in_turns(entries, iters, F32_ROUNDS)
    errs = {side: _rel_err(torch.cat(out, -1) if isinstance(out, list) else out, want)
            for side, out in outs.items()}
    w = in_turns(wrappers, iters, F32_ROUNDS)
    werrs = {side: _rel_err(wrappers[side](), want) for side in wrappers}
    print(f"{label}: C entry {' '.join(f'{side} {t[side]}' for side in t)} ms, wrapper "
          f"{' '.join(f'{side} {w[side]}' for side in w)} ms, bound {bound[0]:.4f} ms by "
          f"{bound[1]} (3xTF32); err/max|want| against float64: entry parent "
          f"{errs['parent']:.3e} change {errs['change']:.3e}, wrapper parent "
          f"{werrs['parent']:.3e} change {werrs['change']:.3e}", flush=True)
    return dict(label=label, **t, wrapper=w, bound_ms=bound[0], roof=bound[1],
                parent_rel_err=errs["parent"], change_rel_err=max(errs["change"],
                                                                  werrs["change"]),
                parent_wrapper_rel_err=werrs["parent"])


def compare_f32_proj(libs: dict, parent_attn, stream: int, iters: int,
                     match: str = "") -> list:
    """The float32 projection GEMM at ``paths.F32_PROJ_SHAPES``: both sides'
    ``gswm_qkv_proj_f32`` and ``qkv_projection`` wrappers in turns, each
    side's error against the float64 product; only the cases whose label
    holds ``match``."""
    from gswm_torch.ops import attention as attn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(18)
    out_cases = []
    for m, c, n in paths.F32_PROJ_SHAPES:
        label = f"f32 proj ({m}, {c}, {n})"
        if match not in label:
            continue
        x = torch.randn((1, m, c), generator=g, device=dev)
        ws = [torch.randn((n, c), generator=g, device=dev) for _ in range(3)]
        outs = {side: [x.new_empty((1, m, n)) for _ in range(3)] for side in libs}
        entries = {side: (lambda side=side: libs[side].call(
            "gswm_qkv_proj_f32", *(t.data_ptr() for t in (x, *ws, *outs[side])), m, c, n,
            stream)) for side in libs}
        wrappers = {"parent": lambda: torch.cat(parent_attn.qkv_projection(x, *ws), -1),
                    "change": lambda: torch.cat(attn.qkv_projection(x, *ws), -1)}
        want = x.double() @ torch.cat(ws).double().t()
        case = _f32_sides(label, entries, wrappers, outs, want, iters, roofline.bound_ms(
            *roofline.projection_cost(m, c, n, roofline.F32), roofline.PEAK_F32_PRODUCTS))
        out_cases.append(dict(case, shape=[m, c, n], head_dim=0))
        del x, ws, outs, want
    return out_cases


def compare_f32(libs: dict, parent_attn, stream: int, iters: int, match: str = "") -> list:
    """The float32 flash core through each side's ``gswm_flash_f32`` (the
    first design's entry; this checkout's runs its pre-pass and the core
    unsplit) and each side's ``flash_attention_split`` wrapper (this
    checkout's takes its key split), in turns, each side's error against
    float64; only the cases whose label holds ``match``."""
    from gswm_torch.ops import attention as attn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(19)
    shapes = [(f"f32 ({b}, {s}, {h}, {d})", b, s, s, h, d)
              for b, s, h, d in paths.F32_FLASH_SHAPES]
    shapes += [(f"f32 split ({b}, {sq}, {sk}, {h}, {d})", b, sq, sk, h, d)
               for b, sq, sk, h, d in paths.F32_SPLIT_SHAPES]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out_cases = []
    for label, b, sq, sk, h, d in shapes:
        if match not in label:
            continue
        q = torch.randn((b, sq, h, d), generator=g, device=dev)
        k, v = (torch.randn((b, sk, h, d), generator=g, device=dev) for _ in range(2))
        outs = {side: torch.empty_like(q) for side in libs}
        entries = {side: (lambda side=side: libs[side].call(
            "gswm_flash_f32", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            outs[side].data_ptr(), b, sq, sk, h, d, stream)) for side in libs}
        # the natural wrapper at Sq == Sk (the split one takes its einsum
        # branch below 512 keys), the split one at Sq != Sk
        mods = {"parent": parent_attn, "change": attn}
        wrappers = {side: ((lambda mod=mod: mod.flash_attention(
                               *(t.reshape(b, -1, h * d) for t in (q, k, v)), h)
                               .view(b, sq, h, d)) if sq == sk
                           else (lambda mod=mod: mod.flash_attention_split(q, k, v)))
                    for side, mod in mods.items()}
        want = torch.cat([_attention_f64(q[i:i + 1], k[i:i + 1], v[i:i + 1])
                          for i in range(b)])
        n = 3 if sk * d >= 9216 * 512 else iters
        case = _f32_sides(label + f" s={attn.f32_key_splits(b, sq, sk, h, d, sms)}", entries,
                          wrappers, outs, want, n, roofline.attention_bound_ms(
                              roofline.attention_cost(b, sq, sk, h, d, elem=roofline.F32),
                              roofline.PEAK_F32_PRODUCTS))
        case["max_abs_diff"] = (outs["parent"] - outs["change"]).abs().max().item()
        out_cases.append(dict(case, shape=[b, sq, sk, h, d], head_dim=d))
        del q, k, v, outs, want
        torch.cuda.empty_cache()
    return out_cases


def _attention_f64(q, k, v) -> torch.Tensor:
    """softmax(q k^T d^-0.5) v of (B, Sq, H, D) q and (B, Sk, H, D) k, v in
    float64."""
    d = q.shape[-1]
    qd, kd, vd = (t.double().transpose(1, 2) for t in (q, k, v))
    logits = qd @ kd.transpose(-1, -2) * d**-0.5
    return (torch.softmax(logits, -1) @ vd).transpose(1, 2)


F32_FORM_ROUNDS = ("natural", "form", "form", "natural")


def compare_f32_forms(lib, stream: int, iters: int, match: str = "") -> list:
    """This checkout's pair-packed, transposed and log-sum-exp forms of the
    float32 core against its natural form (``gswm_flash_f32``) on the same
    q, k and v, in turns; each case's ``natural_max_abs_diff`` is the
    largest difference of the form's output from the natural form's (0:
    bit-equal), and the transposed form's 4-byte copies are held to its
    16-byte ones where S % 4 == 0.  Only the cases whose label holds
    ``match``."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(20)

    def natural(q, k, v, out):
        b, sq, h, d = q.shape
        lib.call("gswm_flash_f32", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, sq, k.shape[1], h, d, stream)

    cases = []
    for b, s, h in paths.F32_PACKED_SHAPES:
        pairs = paths.pairs_of(h)
        cases.append((f"f32 packed ({b}, {s}, {h})", "packed", (b, s, 2 * pairs, 64), pairs))
    for b, s, h, d in (*paths.F32_TRANSPOSED_SHAPES, *paths.F32_TRANSPOSED_WORD_SHAPES):
        cases.append((f"f32 transposed ({b}, {s}, {h}, {d})", "transposed", (b, s, h, d), 0))
    for b, s, h, d in paths.F32_LSE_SHAPES:
        cases.append((f"f32 lse ({b}, {s}, {h}, {d})", "lse", (b, s, h, d), 0))
    out_cases = []
    for label, form, (b, s, h, d), pairs in cases:
        if match not in label:
            continue
        extra = {}
        if form == "packed":
            qkv = torch.randn((b, s, 3 * pairs * 128), generator=g, device=dev)
            q, k, v = (t.reshape(b, s, h, d).contiguous() for t in qkv.split(pairs * 128, -1))
            got = qkv.new_empty((b, s, pairs * 128))

            def run(qkv=qkv, got=got, b=b, s=s, pairs=pairs):
                lib.call("gswm_flash_f32_packed", qkv.data_ptr(), got.data_ptr(), b, s,
                         pairs, stream)

            def as_natural(out, b=b, s=s):
                return out.reshape(b, s, -1)
        elif form == "transposed":
            qkv = torch.randn((3 * h * d, b, s), generator=g, device=dev)
            q, k, v = (t.permute(2, 3, 0, 1).contiguous() for t in qkv.view(3, h, d, b, s))
            got = qkv.new_empty((h * d, b, s))

            def run(qkv=qkv, got=got, b=b, s=s, h=h, d=d,
                    entry="gswm_flash_f32_transposed"):
                lib.call(entry, qkv.data_ptr(), got.data_ptr(), b, s, h, d, stream)

            def as_natural(out, b=b, s=s, h=h, d=d):
                return out.permute(2, 3, 0, 1).reshape(h * d, b, s)
        else:
            q, k, v = (torch.randn((b, s, h, d), generator=g, device=dev) for _ in range(3))
            got = torch.empty_like(q)
            lse = torch.empty((b, h, s), device=dev)

            def run(q=q, k=k, v=v, got=got, lse=lse, b=b, s=s, h=h, d=d):
                lib.call("gswm_flash_f32_lse", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         got.data_ptr(), lse.data_ptr(), b, s, s, h, d, stream)

            def as_natural(out):
                return out
        nat = torch.empty_like(q)
        n = 3 if s * d >= 9216 * 512 else iters
        t = in_turns({"natural": lambda q=q, k=k, v=v, nat=nat: natural(q, k, v, nat),
                      "form": run}, n, F32_FORM_ROUNDS)
        diff = (as_natural(nat) - got).abs().max().item()
        if form == "transposed" and s % 4 == 0:  # the forced 4-byte copies beside
            words = torch.empty_like(got)
            extra = dict(word_copies_ms=time_ms(lambda words=words: run(
                got=words, entry="gswm_flash_f32_transposed_4byte"), n))
            extra["word_max_abs_diff"] = (words - got).abs().max().item()
            diff = max(diff, extra["word_max_abs_diff"])
        bound, roof = roofline.attention_bound_ms(
            roofline.attention_cost(b, s, s, h, d, lse=form == "lse", elem=roofline.F32),
            roofline.PEAK_F32_PRODUCTS)
        print(f"{label}: natural {t['natural']} {form} {t['form']} ms, bound {bound:.4f} ms "
              f"by {roof} (3xTF32), max|natural - {form}| {diff}"
              + (f"; 4-byte copies {extra['word_copies_ms']:.4f} ms, max|16-byte - 4-byte| "
                 f"{extra['word_max_abs_diff']}" if extra else ""), flush=True)
        out_cases.append(dict(label=label, kind=form, shape=[b, s, h, d], head_dim=d, **t,
                              bound_ms=bound, roof=roof, natural_max_abs_diff=diff, **extra))
        del q, k, v, got, nat
        torch.cuda.empty_cache()
    return out_cases


SD14_SETS = {"default": {}, "c": paths.TIER_SWITCHES["c"], "t": paths.SD14_SWITCHES["t"]}


def compare_sd14(libs: dict, iters: int) -> list:
    """The sd-1-4 UNet forward at batch 4 and 8 (guidance) on the default
    route and under ``SD14_SETS``' switch sets, each side's kernel library
    swapped in as the one the wrappers call."""
    pipe = paths.build_pipeline("sd-1-4")
    out = []
    for batch in (paths.BATCH_SD14, 2 * paths.BATCH_SD14):
        inputs = paths.unet_inputs(pipe, batch, res=paths.RES_512)

        def forward():
            with torch.inference_mode():
                return pipe.unet(*inputs)

        for label, switches in SD14_SETS.items():
            wall = {side: [] for side in libs}
            device = {side: [] for side in libs}
            with paths.route_switches(switches):
                for side in ROUNDS:
                    native._LIBRARY = libs[side]
                    wall[side].append(time_ms(forward, iters))
                    device[side].append(sum(device_times(forward, iters).values()))
            native._LIBRARY = libs["change"]
            print(f"sd-1-4 UNet forward ({label}), batch {batch}, 512x512: device parent "
                  f"{device['parent']} change {device['change']} ms; CUDA events parent "
                  f"{wall['parent']} change {wall['change']} ms", flush=True)
            out.append(dict(batch=batch, switches=label, device_ms=device, ms=wall))
    del pipe
    torch.cuda.empty_cache()
    return out


def compare_lse(libs: dict, rand, stream: int, iters: int, match: str = "") -> list:
    """The split kernel with its log-sum-exp output at ``LSE_SHAPES``, only
    the cases whose label holds ``match``."""
    from gswm_torch.ops import attention as attn

    out_cases = []
    for b, s, h, d in LSE_SHAPES:
        label = f"K4 lse ({b}, {s}, {h}, {d})"
        if match not in label:
            continue
        q, k, v = (rand(b, s, h, d) for _ in range(3))
        outs = {side: torch.empty_like(q) for side in libs}
        lses = {side: torch.empty((b, h, s), dtype=torch.float32, device=q.device)
                for side in libs}
        with_lse = {side: (lambda side=side: libs[side].call(
            "gswm_flash_split_lse", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            outs[side].data_ptr(), lses[side].data_ptr(), b, s, s, h, d, stream))
            for side in libs}
        without = {side: (lambda side=side: libs[side].call(
            "gswm_flash_split", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            outs[side].data_ptr(), b, s, s, h, d, stream)) for side in libs}
        t = in_turns(with_lse, iters)
        device = {side: dict(lse=device_ms(with_lse[side], iters),
                             no_lse=device_ms(without[side], iters)) for side in libs}
        for side in libs:
            with_lse[side]()
        diff = (outs["parent"].float() - outs["change"].float()).abs().max().item()
        lse_diff = (lses["parent"] - lses["change"]).abs().max().item()
        case = dict(label=label, shape=[b, s, h, d], head_dim=d, **t, device_ms=device,
                    max_abs_diff=diff, lse_max_abs_diff=lse_diff)
        if s >= attn.SPLIT_MIN_KEYS:  # below, the wrapper takes its einsum branch
            wrap = {True: [], False: []}
            for on in (True, False, False, True):
                wrap[on].append(time_ms(
                    lambda on=on: attn.flash_attention_split(q, k, v, return_lse=on), iters))
            case["wrapper_ms"] = dict(lse=wrap[True], no_lse=wrap[False])
        case["lse_empty_us"] = host_us(
            lambda: torch.empty((b, h, s), dtype=torch.float32, device=q.device))
        bound, roof = roofline.attention_bound_ms(
            roofline.attention_cost(b, s, s, h, d, lse=True))
        case.update(bound_ms=bound, roof=roof)
        print(f"{label}: parent {t['parent']} change {t['change']} ms; device, lse / "
              f"without: parent {device['parent']['lse']:.4f} / "
              f"{device['parent']['no_lse']:.4f}, change {device['change']['lse']:.4f} / "
              f"{device['change']['no_lse']:.4f} ms; wrapper lse / without "
              f"{case.get('wrapper_ms')}; torch.empty of the lse "
              f"{case['lse_empty_us']:.2f} us; bound {bound:.4f} ms by {roof}; "
              f"max|parent - change| {diff:.5f}, lse {lse_diff:.6f}", flush=True)
        out_cases.append(case)
    return out_cases


if __name__ == "__main__":
    main()
    sys.exit(0)
