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

Float32 kernels (csrc/qkv_proj_f32.cu, csrc/flash_f32.cu in each of its
forms, csrc/group_norm.cu on float32) move 4 bytes an element, and their
products must have fp32 accuracy: the least time the
card gives such products in is 3xTF32 on the tensor cores (each operand
split into a big and a small TF32 part, three products), a third of the
dense TF32 rate, ``PEAK_F32_PRODUCTS``: the attention core and the
projection GEMM run on just that (3xTF32 wgmma; their first design ran on
the CUDA cores' FFMA, ``PEAK_FP32``, which is still the rate of GroupNorm's
fp32 arithmetic).  TF32 alone keeps a 10-bit mantissa and is
no float32.  The steps around the float32 core, the split pre-pass and the
combine of its key chunks, move bytes and do a few operations an element:
their bound is bytes (``f32_prepass_cost``, ``f32_combine_cost``).

``PEAK_INT32``: ChaCha20 is 32-bit integer adds, XORs and rotations
(funnel shifts, or byte permutes for 16 and 8 bits), and the vote's
counters are bitwise operations.  The CUDA C Programming Guide's arithmetic
instruction throughput table gives compute capability 9.0 64 results a
clock an SM for 32-bit integer add, for 32-bit bitwise AND, OR and XOR and
for funnel shifts (the integer ALU), against 128 for fp32 add, multiply and
FMA; and 64 for 32-bit integer multiply-add, which issues on the FMA pipe,
where the compiler also puts adds (a multiply-add by 1).  So XORs and
rotations run at 64 a clock, adds beside them on the other pipe, and the
least time of a mix is its XORs and rotations (plus any adds beyond them,
halved) at 64 a clock: ``chacha_cost`` counts those.  At ``PEAK_FP32``'s
clock (67e12 FLOP/s over 132 SMs x 128 FMA x 2 FLOP: 1.98 GHz) 64 a clock
is 132 x 64 x 1.98e9 = 16.75e12 a second.  The single-key kernel at 2^20
blocks (0.0492 ms on the card) retires ChaCha20's 976 operations a block
at 20.8e12 a second, above 64 a clock for all of them: the adds do take
the second pipe.
"""

from __future__ import annotations

import math

PEAK_BYTES = 3.35e12      # HBM3, bytes/s
PEAK_BF16 = 989e12        # tensor cores, bf16 in, fp32 accumulate, FLOP/s
PEAK_TF32 = 494.5e12      # tensor cores, TF32 dense, FLOP/s
PEAK_F32_PRODUCTS = PEAK_TF32 / 3  # products of fp32 accuracy: 3xTF32
PEAK_FP32 = 67e12         # outside the tensor cores, FLOP/s (an FMA is 2)
# 32-bit bitwise ops and funnel shifts on the integer ALU: 64 a clock an SM,
# half the fp32 FMAs, each of which PEAK_FP32 counts as 2 FLOP
PEAK_INT32 = PEAK_FP32 / 4
PEAK_EXP2 = 132 * 16 * 1.83e9  # ex2.approx on the SFUs, a second
BF16 = 2                  # bytes
F32 = 4


def bound_ms(ops: float, nbytes: float, peak_ops: float,
             exps: float = 0) -> tuple[float, str]:
    """(least milliseconds, which roof gives it: "operations",
    "exponentials" or "bytes"); a tie goes to the one named first."""
    times = {"operations": ops / peak_ops, "exponentials": exps / PEAK_EXP2,
             "bytes": nbytes / PEAK_BYTES}
    roof = max(times, key=times.get)
    return 1e3 * times[roof], roof


def attention_cost(b: int, sq: int, sk: int, h: int, d: int,
                   lse: bool = False, elem: int = BF16) -> tuple[int, int, int]:
    """(FLOP, bytes, exponentials) of softmax(q k^T) v on (B, Sq, H, D) q and
    (B, Sk, H, D) k/v of ``elem`` bytes an element (bf16 by default): two
    products of 2 * Sq * Sk * D each per head, q and out of Sq rows, k and v
    of Sk, one exponential a logit; with ``lse``, the fp32 (B, H, Sq)
    log-sum-exp written too."""
    return (4 * b * h * sq * sk * d,
            elem * b * h * d * (2 * sq + 2 * sk) + (4 * b * h * sq if lse else 0),
            b * h * sq * sk)


def attention_bound_ms(cost: tuple[int, int, int],
                       peak_ops: float = PEAK_BF16) -> tuple[float, str]:
    """``bound_ms`` of an ``attention_cost`` or ``fused_qkv_cost``: the
    products at ``peak_ops`` (the tensor cores' bf16 rate; a float32
    kernel's ``PEAK_F32_PRODUCTS``), the exponentials on the SFUs."""
    flops, nbytes, exps = cost
    return bound_ms(flops, nbytes, peak_ops, exps)


def projection_cost(m: int, c: int, n: int, elem: int = BF16) -> tuple[int, int]:
    """(FLOP, bytes) of the three projections q, k, v (M, N) = x (M, C) @ w
    (N, C)^T, ``elem`` bytes an element (bf16 by default)."""
    return 2 * m * c * 3 * n, elem * (m * c + 3 * n * c + 3 * m * n)


def fused_qkv_cost(b: int, s: int, c: int, h: int,
                   d: int = 64) -> tuple[int, int, int]:
    """(FLOP, bytes, exponentials) of fused-qkv self-attention: projections
    plus attention; x and the weights are read, only the output is written
    (q, k and v are no output of the function)."""
    n = h * d
    proj, _ = projection_cost(b * s, c, n)
    attn, _, exps = attention_cost(b, s, s, h, d)
    return proj + attn, BF16 * (b * s * c + 3 * n * c + b * s * n), exps


def group_norm_cost(shape: tuple[int, ...], elem: int = BF16) -> tuple[int, int]:
    """(FLOP, bytes) of GroupNorm (+ SiLU) on an NCHW tensor of ``elem``
    bytes an element (bf16 by default; float32: 4): one read and one write,
    and some 8 fp32 operations an element (two moments, normalise, affine,
    activation)."""
    n = math.prod(shape)
    return 8 * n, 2 * elem * n


def chacha_cost(n_blocks: int) -> tuple[int, int]:
    """(32-bit integer operations on the integer ALU, bytes) of ``n_blocks``
    ChaCha20 blocks, 64 bytes out: a block is 80 quarter-rounds of 4 adds,
    4 XORs and 4 rotations and 16 final adds, 976 operations, of which the
    640 XORs and rotations have only the ALU; the 336 adds fit beside them
    on the FMA pipe (``PEAK_INT32``), so the 640 set the least time."""
    return n_blocks * 80 * 8, 64 * n_blocks


def chacha_batch_cost(rows: int, n_bits: int) -> tuple[int, int]:
    """(32-bit integer operations, bytes) of ``rows`` keystreams of ``n_bits``
    bits written as bits, one byte each (``batch_keystream_bits``): every row
    computes ceil(n_bits / 512) whole blocks at ``chacha_cost``'s count, reads
    its 48 bytes of key, counter and nonce and writes n_bits bytes.  The
    words themselves are no output, so their 64 bytes a block are not
    counted; the bytes, 8 for each byte of keystream, are the larger roof."""
    ops, _ = chacha_cost(rows * -(-n_bits // 512))
    return ops, rows * n_bits + rows * 48


def chacha_vote_cost(rows: int, n_bits: int, mb: int, shared_latent: bool,
                     scores: bool = True) -> tuple[int, int]:
    """(32-bit integer operations on the integer ALU, bytes) of
    ``chacha.batch_vote``: the blocks that hold the complete segments' bits
    at ``chacha_cost``'s count, an XOR and a full adder's two bitwise
    operations into the bit-sliced counts for each of their words, and for
    each message word the comparison with the count and, with ``scores``,
    an XOR and a popcount.  Bytes: each row's
    48 of key, counter and nonce; the latent's packed words
    (``chacha.block_words``), once (``shared_latent``) or once a row; with
    ``scores`` the expected words, ceil(mb / 32) a row, and a float32 a row
    written, else mb bytes a row of voted bits.  Arithmetic binds."""
    segs = n_bits // mb
    vote_words = -(-segs * mb // 32)
    blocks = -(-vote_words // 16)
    ew = -(-mb // 32)
    ops, _ = chacha_cost(rows * blocks)
    ops += rows * (3 * vote_words + ew * (3 if scores else 1))
    latent = 64 * -(-n_bits // 512) * (1 if shared_latent else rows)
    out = rows * (4 * ew + 4) if scores else rows * mb
    return ops, rows * 48 + latent + out


def chacha_embed_cost(rows: int, elements: int, l: int) -> tuple[int, int]:
    """(32-bit integer operations on the integer ALU, bytes) of
    ``chacha.batch_embed``: every row's ceil(elements * l / 512) blocks at
    ``chacha_cost``'s count of XORs and rotations, against the bytes: u read
    and z written, 4 each an element, the payload's packed words
    (``chacha.block_words``, 64 bytes a block) and 48 bytes of key, counter
    and nonce a row.  The keystream and the cipher bits are no input or
    output.  The bytes bind at every l."""
    blocks = -(-elements * l // 512)
    ops, _ = chacha_cost(rows * blocks)
    return ops, rows * (8 * elements + 64 * blocks + 48)


def f32_prepass_cost(b: int, sk: int, h: int, d: int) -> tuple[int, int]:
    """(FLOP, bytes) of the float32 core's split pre-pass: k and v read once
    (4 bytes an element), their big and small parts written, each B H Skp
    Dp floats (keys padded to 64-key tiles, columns to 64-column panels);
    three operations an element (two roundings, a subtraction)."""
    keys, cols = -(-sk // 64) * 64, -(-d // 64) * 64
    return 3 * 2 * b * h * sk * d, F32 * (2 * b * h * sk * d + 4 * b * h * keys * cols)


def f32_combine_cost(splits: int, b: int, sq: int, h: int, d: int,
                     lse: bool = False) -> tuple[int, int]:
    """(FLOP, bytes) of the combine of ``splits`` key chunks: each chunk's
    partial output, running max and row sum read, the output (and, with
    ``lse``, the log-sum-exp) written; two operations a partial element."""
    rows = b * h * sq
    return 2 * splits * rows * d, F32 * (splits * rows * (d + 2) + rows * d
                                         + (rows if lse else 0))
