"""The least time one NVIDIA H100 (SXM) could take for a kernel's work.

A kernel's bound is the largest of its times: the bytes the function must
move (each input read once, each output written once, whatever the kernel
reads again) over the card's memory rate, the operations it does over the
card's peak rate for their type and, for attention, its exponentials over
the rate of the special function units.  Counts come from shapes alone, so
they can be checked by hand; times on the card are measured elsewhere
(``chip_smoke.py``, ``gswm_torch/tools``) and divided by these.

Peaks are NVIDIA's published dense rates at the full 700 W power limit.
``PEAK_EXP2``: every attention kernel of the port computes its B * H * Sq *
Sk exponentials with ``ex2.approx``, which the SFUs issue at 16 a clock an
SM on compute capability 9.0 (CUDA C Programming Guide, arithmetic
instruction throughput), at the 1.83 GHz that the bf16 peak implies
(989e12 FLOP/s over 132 SMs x 4096 FLOP a clock): 132 x 16 x 1.83e9 =
3.865e12 a second.  Per logit the tensor cores need 4 * d FLOP, so the two
roofs are equal at d = 64 and the exponentials bind below it.
"""

from __future__ import annotations

import math

PEAK_BYTES = 3.35e12      # HBM3, bytes/s
PEAK_BF16 = 989e12        # tensor cores, bf16 in, fp32 accumulate, FLOP/s
PEAK_FP32 = 67e12         # outside the tensor cores, FLOP/s (an FMA is 2)
# 32-bit integer adds, xors and rotates issue at most as fast as fp32
# instructions (half the FLOP rate, since an FMA counts twice)
PEAK_INT32 = PEAK_FP32 / 2
PEAK_EXP2 = 132 * 16 * 1.83e9  # ex2.approx on the SFUs, a second
BF16 = 2                  # bytes


def bound_ms(ops: float, nbytes: float, peak_ops: float,
             exps: float = 0) -> tuple[float, str]:
    """(least milliseconds, which roof gives it: "operations",
    "exponentials" or "bytes"); a tie goes to the one named first."""
    times = {"operations": ops / peak_ops, "exponentials": exps / PEAK_EXP2,
             "bytes": nbytes / PEAK_BYTES}
    roof = max(times, key=times.get)
    return 1e3 * times[roof], roof


def attention_cost(b: int, sq: int, sk: int, h: int, d: int,
                   lse: bool = False) -> tuple[int, int, int]:
    """(FLOP, bytes, exponentials) of softmax(q k^T) v on bf16 (B, Sq, H, D)
    q and (B, Sk, H, D) k/v: two products of 2 * Sq * Sk * D each per head,
    q and out of Sq rows, k and v of Sk, one exponential a logit; with
    ``lse``, the fp32 (B, H, Sq) log-sum-exp written too."""
    return (4 * b * h * sq * sk * d,
            BF16 * b * h * d * (2 * sq + 2 * sk) + (4 * b * h * sq if lse else 0),
            b * h * sq * sk)


def attention_bound_ms(cost: tuple[int, int, int]) -> tuple[float, str]:
    """``bound_ms`` of an ``attention_cost`` or ``fused_qkv_cost``: the
    products on the tensor cores (bf16), the exponentials on the SFUs."""
    flops, nbytes, exps = cost
    return bound_ms(flops, nbytes, PEAK_BF16, exps)


def projection_cost(m: int, c: int, n: int) -> tuple[int, int]:
    """(FLOP, bytes) of the three bf16 projections q, k, v (M, N) = x (M, C)
    @ w (N, C)^T."""
    return 2 * m * c * 3 * n, BF16 * (m * c + 3 * n * c + 3 * m * n)


def fused_qkv_cost(b: int, s: int, c: int, h: int,
                   d: int = 64) -> tuple[int, int, int]:
    """(FLOP, bytes, exponentials) of fused-qkv self-attention: projections
    plus attention; x and the weights are read, only the output is written
    (q, k and v are no output of the function)."""
    n = h * d
    proj, _ = projection_cost(b * s, c, n)
    attn, _, exps = attention_cost(b, s, s, h, d)
    return proj + attn, BF16 * (b * s * c + 3 * n * c + b * s * n), exps


def group_norm_cost(shape: tuple[int, ...]) -> tuple[int, int]:
    """(FLOP, bytes) of GroupNorm (+ SiLU) on a bf16 NCHW tensor: one read
    and one write, and some 8 fp32 operations an element (two moments,
    normalise, affine, activation)."""
    n = math.prod(shape)
    return 8 * n, 2 * BF16 * n


def chacha_cost(n_blocks: int) -> tuple[int, int]:
    """(32-bit integer operations, bytes) of ``n_blocks`` ChaCha20 blocks:
    80 quarter-rounds of 12 operations plus 16 final adds, 64 bytes out."""
    return n_blocks * (80 * 12 + 16), 64 * n_blocks


def chacha_batch_cost(rows: int, n_bits: int) -> tuple[int, int]:
    """(32-bit integer operations, bytes) of ``rows`` keystreams of ``n_bits``
    bits written as bits, one byte each (``batch_keystream_bits``): every row
    computes ceil(n_bits / 512) whole blocks at ``chacha_cost``'s count, reads
    its 48 bytes of key, counter and nonce and writes n_bits bytes.  The
    words themselves are no output, so their 64 bytes a block are not
    counted; the bytes, 8 for each byte of keystream, are the larger roof."""
    ops, _ = chacha_cost(rows * -(-n_bits // 512))
    return ops, rows * n_bits + rows * 48
