"""Self-attention kernels of the PyTorch port, with their plain versions.

Five kernels, hand-written CUDA for Hopper (``gswm_torch/csrc``), all on
wgmma + TMA, behind six wrappers; ``route_self_attention`` picks the UNet's
tier as the JAX package does.  Every layout but the pair-packed one takes
any head dim d with d % 8 == 0 up to 512 (``kernel_takes_head_dim``), and
in every one of them d <= 48 runs csrc/flash_hopper.cu's narrow kernel and
64 < d <= 160 the kernel of csrc/flash_mid.cu (whole 64-column panels and a
tail of the last panel's columns rounded up to 16), each with the layout a
template parameter; 48 < d <= 64 runs flash_hopper.cu's d <= 64 kernel
(transposed: csrc/flash_transposed.cu's), every wider d a split kernel at d
rounded up to a multiple of 64 (csrc/flash_split.cu; transposed:
flash_transposed.cu's); ``head_dim_kernel`` names each d's kernel, panels
and tail in either layout.  The kernels' tensor maps zero-fill the columns
(transposed: rows) past d (SD 1.x: 40, 80, 160):

  * ``flash_attention_split`` — split-layout flash attention on
    (B, S, H, D) q/k/v: csrc/flash_hopper.cu up to D = 64,
    csrc/flash_mid.cu to 160, csrc/flash_split.cu (D split across two
    consumer warpgroups) above.
    Port of the
    Pallas ``gswm.ops.attention.flash_attention``; serves the VAE mid-block
    attention above 4096 tokens (one head, D = 512) and the UNet's
    ``split`` route.  With ``return_lse`` the same kernels also write each
    row's log-sum-exp (``gswm_flash_split_lse``): the per-step kernel of
    ``ops.ring_attention``.  ``flash_attention_sharded`` partitions it over
    a mesh (``gswm_torch.sharding``): the ring under sp, heads under tp.
  * ``flash_attention`` — the same kernels on natural-layout (B, S, H*D)
    q/k/v, which is (B, S, H, D) memory.  Serves the UNet's ``xf`` and
    ``cres`` routes (level 0: 4096 tokens at 512x512, 9216 at 768x768),
    where the TPU path runs ``gswm.ops.attention.xla_flash_attention`` or
    the Pallas ``flash_attention_cres``.
  * ``flash_attention_packed`` — the D = 64 kernel reading q, k and v as
    strided views of one pair-packed (B, S, 3*P*128) qkv array.  Port of
    the Pallas ``flash_attention_packed``; the ``packed`` route.
  * ``flash_attention_transposed`` (csrc/flash_transposed.cu) — flash
    attention on the (3*H*D, B, S) transposed projection output, the
    tiles read as they lie (MN-major q and k, K-major v): the kernel
    ``head_dim_kernel(d, "transposed")`` names, at every S.  Port of the
    Pallas ``flash_attention_transposed``; the ``transposed`` route.  Where
    S is no multiple of 8 no tensor map can address the rows: to d = 160
    the same design runs with its boxes loaded and stored by hand
    (``transposed_kernel`` names that form with ``ROWS_FORM``); above, a
    pre-pass copies the input into scratch of a token pitch rounded up to
    8 and the design reads that by tensor maps (``ALIGNED_FORM``).
  * ``fused_qkv_attention`` (csrc/fused_qkv.cu, then the kernel of the
    head dim) — the bias-free q/k/v projections in a hand-written wgmma +
    TMA GEMM, then attention.  Port of the Pallas ``flash_attention_fused_qkv`` in
    both its layouts (all heads, and the sequential-head
    ``_fused_qkv_kernel_seqhead``); serves 256..2304 tokens (levels 1 and
    2).  ``qkv_projection`` is its GEMM alone.

All compute exact softmax (the TPU kernels' ``use_max`` recurrence).  The
TPU bf16 paths (and the transposed kernel on every dtype) drop the running
max and clamp logits at 60 (``_NOMAX_CLAMP``); the two agree within
rounding while |logit| < 60.

The kernels above take bfloat16.  Two more take float32, every product
of float32 accuracy on the tensor cores (3xTF32 wgmma: each operand split
into a big and a small TF32 part, ``split_tf32``, three products a term)
and every sum in fp32, as the TPU kernels take fp32 (those that keep a
running max do so outside bf16: gswm/ops/attention.py:261, :720, :982,
:1231): csrc/qkv_proj_f32.cu, the projection GEMM at the widths the bf16
GEMM takes; and csrc/flash_f32.cu, the flash core at 8 <= d <= 512 (SD
2.x's 64, SD 1.x's 40, 80 and 160, the VAE's 512; a template on the
number of 64-column panels, p v's width of the last one and the layout),
in four forms: the natural layout, with or without the log-sum-exp; the
pair-packed one (the natural layout with pitches of its own); and the
transposed one (q by 16-byte copies where S % 4 == 0, 4-byte ones
elsewhere).  Each float32 attention call is three steps, its scratch and
workspace from PyTorch (``f32_core``): the split pre-pass (k and v into
big and small parts, K-major), the core over s key chunks
(``f32_key_splits`` picks s from the shape and the SM count) and, where s
> 1, the combine.  So in float32 every wrapper launches them, and every
other dtype raises a TypeError that names it (``dtype_kernel`` states the
rule).  Their launches count in ``<wrapper>.launches_f32``, one a call,
and by head dim in ``<wrapper>.launches_f32_by_d`` (with the log-sum-exp
in ``flash_attention_split.lse_launches_f32[_by_d]``); the bf16 counters
do not move.  ``flash_attention_3xtf32_reference`` models the core's
arithmetic, key split included, from ``split_tf32``: the tests predict the
kernel's error with it; nothing on the card's path calls it.

On a CPU tensor each wrapper runs its plain PyTorch version; on a CUDA
tensor it launches its kernel or raises, and it raises under a gradient
(``native.refuse_grad``): no kernel has a backward.  Each wrapper counts
its launches in a plain integer attribute, ``<wrapper>.launches``, and by
head dim in a dict, ``<wrapper>.launches_by_d``.

Weights are in ``torch.nn.Linear``'s (out, in) layout: q = x @ wq.T.
"""

from __future__ import annotations

import functools
import math
import os

import torch

from gswm_torch import native

HEAD_DIM = 64  # the packed kernel's head dim (SD 2.x, SDXL)
# the head dims every other attention kernel takes: d % 8 == 0 (16-byte rows
# for the tensor maps), 8 <= d <= 512
KERNEL_MAX_HEAD_DIM = 512

# The JAX package's routing defaults (gswm/models/layers.py:224-386): the
# xf, cres, packed and transposed tiers start at 2305 tokens, fused-qkv
# covers 256..2304, the split flash kernel takes what is left from
# ``flash_min_seq`` (1024) up, plain matmul + softmax below.
TIER_MIN_SEQ = 2305
FUSED_QKV_MIN_SEQ = 256
FUSED_QKV_MAX_SEQ = 2304
FLASH_MIN_SEQ = 1024
# every switch route_self_attention reads
ROUTE_SWITCHES = (
    "GSWM_XF_ATTN", "GSWM_XF_ATTN_MIN_SEQ", "GSWM_CRES_ATTN", "GSWM_CRES_ATTN_MIN_SEQ",
    "GSWM_PACKED_ATTN", "GSWM_PACKED_ATTN_MIN_SEQ", "GSWM_PACKED_ATTN_MAX_SEQ",
    "GSWM_TRANSPOSED_ATTN", "GSWM_TRANSPOSED_ATTN_MIN_SEQ", "GSWM_FUSED_QKV",
    "GSWM_FUSED_QKV_MAX_SEQ", "GSWM_FUSED_QKV_MODE", "GSWM_FLASH_MIN_SEQ")


def _seq_switch(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def kernel_takes_head_dim(d: int) -> bool:
    """Whether the attention kernels (all but the pair-packed one) take head
    dim ``d``: d % 8 == 0 and 8 <= d <= 512."""
    return 8 <= d <= KERNEL_MAX_HEAD_DIM and d % 8 == 0


def kernel_head_dim(d: int) -> int:
    """The width of the 64-column (transposed: 64-row) panels a head of dim
    ``d`` lands in, in every layout: 64 for d <= 64, else d rounded up to a
    multiple of 64 (the tensor maps zero-fill past d); the split kernels
    of csrc/flash_split.cu and csrc/flash_transposed.cu compute on all of it
    (192 ... 512), ``head_dim_kernel`` says what each kernel computes.
    Raises ValueError for a d the kernels do not take
    (``kernel_takes_head_dim``)."""
    if not kernel_takes_head_dim(d):
        raise ValueError(f"head dim {d}: the attention kernels take d % 8 == 0, "
                         f"8 <= d <= {KERNEL_MAX_HEAD_DIM}")
    return max(HEAD_DIM, -(-d // 64) * 64)


# the widest head of csrc/flash_hopper.cu's narrow kernel, and of
# csrc/flash_mid.cu's
NARROW_MAX_HEAD_DIM = 48
MID_MAX_HEAD_DIM = 160


LAYOUTS = ("natural", "transposed")


def head_dim_kernel(d: int, layout: str = "natural") -> tuple[str, int, int]:
    """(kernel, full panels, tail N): the kernel that runs head dim ``d`` in
    ``layout``, the 64-wide panels whose p v it computes at N = 64, and the
    width N of its p v on the last panel (0: none past the full ones).  The
    natural layout is that of the natural, split and fused-qkv wrappers
    (``gswm_flash_split``'s dispatch, csrc/flash_split.cu); the transposed
    one that of ``flash_attention_transposed`` at every S
    (csrc/flash_transposed.cu's launch_form).  The logits take ceil(d / 16)
    k16 steps in all, but in the split kernels, which compute whole panels.

      d <= 48        flash_narrow_kernel (csrc/flash_hopper.cu), p v at N = 48
      48 < d <= 64   one panel: flash_hopper_kernel (transposed:
                     flash_transposed_kernel, csrc/flash_transposed.cu)
      64 < d <= 160  flash_mid_kernel (csrc/flash_mid.cu): the last panel's
                     columns (transposed: rows) rounded up to 16 are its
                     tail, a tail of 64 a full panel: 72 and 80 one panel
                     and 16, 128 two and 0, 160 two and 32
      d > 160        flash_split_kernel (csrc/flash_split.cu, the layout a
                     template parameter), whole panels of
                     ``kernel_head_dim``

    Raises ValueError for a d the kernels do not take, or another layout."""
    width = kernel_head_dim(d)
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r}: one of {LAYOUTS}")
    transposed = layout == "transposed"
    if d <= NARROW_MAX_HEAD_DIM:
        return "flash_narrow_kernel", 0, NARROW_MAX_HEAD_DIM
    if d <= HEAD_DIM:
        return "flash_transposed_kernel" if transposed else "flash_hopper_kernel", 1, 0
    if d <= MID_MAX_HEAD_DIM:
        before = (d - 1) // 64  # the panels before the last
        tail = -(-(d - 64 * before) // 16) * 16 % 64
        return "flash_mid_kernel", before + (tail == 0), tail
    return "flash_split_kernel", width // 64, 0


# What ``transposed_kernel`` appends to a design's name in its hand-loaded
# form (csrc/hopper.cuh Layout::rows): where S % 8 != 0 the transposed
# layout's rows start at any even address and no tensor map can address
# them, so the producer warpgroup loads the boxes and the consumers store
# their output by hand, into and out of the same tiles.
ROWS_FORM = "/rows"
# What it appends above d = 160 instead: the split kernel takes tensor maps
# alone, so where S % 8 != 0 a pre-pass (csrc/flash_transposed.cu
# align_tokens_kernel) copies the input into scratch of a token pitch
# rounded up to 8, and the output is stored by hand into the true array
ALIGNED_FORM = "/aligned"


# The float32 flash kernel: csrc/flash_f32.cu's, a template on P = ceil(d /
# F32_PANEL) panels of F32_PANEL columns, to KERNEL_MAX_HEAD_DIM, on the
# width of p v's last panel (exact at the widths users run,
# ``F32_EXACT_TAILS``; F32_PANEL, v's zero columns computed, elsewhere) and
# on the layout: the natural layout's kernel also serves the log-sum-exp (a
# pointer, null for none) and the pair-packed layout (pitches of its own).
# A block is one key chunk of F32_BLOCK_ROWS query rows, F32_WIDE_ROWS above
# F32_ROW_PANELS panels (both warpgroups on the same rows), one block an SM.
F32_PANEL = 64
F32_FLASH_KERNEL = "flash_f32_kernel"
F32_EXACT_TAILS = {40: 40, 80: 16, 160: 32}
F32_ROW_PANELS = 4
F32_BLOCK_ROWS = 128
F32_WIDE_ROWS = 64
F32_KEY_TILE = 64
F32_MAX_SPLITS = 16
F32_MIN_CHUNK_TILES = 4
F32_BLOCK_TILES = 1
# What ``transposed_kernel`` appends to the float32 kernel's name where S %
# 4 != 0: the transposed layout's rows then start at any 4-byte address, and
# q comes by 4-byte cp.async instead of 16-byte ones
F32_WORD_FORM = "/4-byte"
# the dtypes every attention wrapper's kernels take
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
# ``dtype_kernel``'s layouts: ``LAYOUTS`` and the pair-packed one (d = 64)
PACKED = "packed"


def dtype_kernel(dtype: torch.dtype, d: int, layout: str = "natural") -> str:
    """The attention kernel that runs head dim ``d`` on ``dtype`` tensors in
    ``layout`` (one of ``LAYOUTS``, or ``PACKED`` at d = 64): in bfloat16
    the kernel ``head_dim_kernel`` names (packed: flash_hopper.cu's d = 64
    kernel); in float32 ``F32_FLASH_KERNEL`` (csrc/flash_f32.cu, 3xTF32
    wgmma) with its panel count and the width of p v's last panel,
    ``flash_f32_kernel<P, N>``, P = ceil(d / F32_PANEL), N =
    ``F32_EXACT_TAILS.get(d, F32_PANEL)``, in the natural and packed layouts
    and with the log-sum-exp, and ``flash_f32_kernel<P, N, transposed>`` in
    the transposed one (each call also runs the pre-pass ``split_kv_kernel``
    and, where ``f32_key_splits`` gives s > 1, ``combine_kernel``).  Raises
    TypeError, naming the dtype, where no kernel takes it (float16 and every
    other dtype), ValueError for a d no kernel takes or another layout."""
    if layout == PACKED:
        if d != HEAD_DIM:
            raise ValueError(f"head dim {d}: the pair-packed layout holds heads of "
                             f"{HEAD_DIM}")
        kernel = head_dim_kernel(d)[0]
    else:
        kernel = head_dim_kernel(d, layout)[0]
    if dtype == torch.bfloat16:
        return kernel
    if dtype == torch.float32:
        panels = -(-d // F32_PANEL)
        tail = F32_EXACT_TAILS.get(d, F32_PANEL)
        return (f"{F32_FLASH_KERNEL}<{panels}, {tail}"
                f"{', transposed' if layout == 'transposed' else ''}>")
    raise TypeError(f"the attention kernels take torch.bfloat16 and torch.float32; "
                    f"got {dtype}")


def transposed_kernel(d: int, s: int, dtype: torch.dtype = torch.bfloat16) -> str:
    """The kernel ``flash_attention_transposed`` runs head dim ``d`` over
    ``s`` tokens of ``dtype`` on.  bfloat16: ``head_dim_kernel(d,
    "transposed")``'s design at every S, its boxes by tensor maps where S %
    8 == 0; elsewhere by hand to d = 160 (the name followed by
    ``ROWS_FORM``) and above it by tensor maps over the aligning pre-pass's
    scratch (followed by ``ALIGNED_FORM``).  float32: ``dtype_kernel``'s, q
    by 16-byte copies where S % 4 == 0 and by 4-byte ones elsewhere
    (followed by ``F32_WORD_FORM``)."""
    kernel = dtype_kernel(dtype, d, "transposed")
    if dtype == torch.float32:
        return kernel + F32_WORD_FORM if s % 4 else kernel
    if not s % 8:
        return kernel
    return kernel + (ALIGNED_FORM if d > MID_MAX_HEAD_DIM else ROWS_FORM)


def aligned_pitch(s: int) -> int:
    """The token pitch of K7's pre-pass scratch: S rounded up to 8."""
    return -(-s // 8) * 8


def align_tokens_reference(x: torch.Tensor, pitch: int) -> torch.Tensor:
    """Plain version of K7's pre-pass (csrc/flash_transposed.cu
    align_tokens_kernel): (..., S) rows -> (..., pitch), the tokens from S
    zero."""
    return torch.nn.functional.pad(x, (0, pitch - x.shape[-1]))


def flash_attention_transposed_aligned_reference(qkv_t: torch.Tensor,
                                                 heads: int) -> torch.Tensor:
    """Plain K7 over its pre-pass: the (3*H*D, B, S) input copied to
    ``aligned_pitch(S)`` tokens a row, read back at the true S as the
    tensor maps read the scratch (the tokens past S never reach the
    products), then ``flash_attention_transposed_reference``."""
    s = qkv_t.shape[-1]
    padded = align_tokens_reference(qkv_t, aligned_pitch(s))
    return flash_attention_transposed_reference(padded[..., :s], heads)


def _count(wrapper, d: int, dtype: torch.dtype = torch.bfloat16,
           name: str = "launches") -> None:
    """One launch at head dim d on ``wrapper.<name>`` and ``<name>_by_d``,
    in float32 on ``<name>_f32`` and ``<name>_f32_by_d``."""
    if dtype == torch.float32:
        name += "_f32"
    setattr(wrapper, name, getattr(wrapper, name) + 1)
    by_d = getattr(wrapper, name + "_by_d")
    by_d[d] = by_d.get(d, 0) + 1


@functools.lru_cache(maxsize=4096)
def f32_key_splits(b: int, sq: int, sk: int, h: int, d: int, sms: int) -> int:
    """The number of key chunks s the float32 core splits the keys of a (B,
    Sq, Sk, H, d) call into on a card of ``sms`` SMs, from the shape alone
    (every form of one shape takes the same s, so the forms stay bit-equal).
    A block is one chunk of ``F32_BLOCK_ROWS`` query rows of one (b, h)
    (``F32_WIDE_ROWS`` above ``F32_ROW_PANELS`` panels), one block an SM.
    s = 1 where no wave of blocks is under half full; else the s whose
    waves are none under half full with the least cost, waves times (key
    tiles a chunk + ``F32_BLOCK_TILES``, a block's own start and end in
    tiles), the least s on a tie, every chunk whole tiles, none empty and
    none under ``F32_MIN_CHUNK_TILES`` tiles, s at most ``F32_MAX_SPLITS``."""
    rows = F32_WIDE_ROWS if -(-d // F32_PANEL) > F32_ROW_PANELS else F32_BLOCK_ROWS
    blocks = -(-sq // rows) * h * b
    tiles = -(-sk // F32_KEY_TILE)

    def filled(n):  # no wave under half full
        return n % sms == 0 or 2 * (n % sms) >= sms

    if filled(blocks):
        return 1
    best = None
    for s in range(1, min(tiles, F32_MAX_SPLITS) + 1):
        per = -(-tiles // s)
        if -(-tiles // per) != s or (s > 1 and per < F32_MIN_CHUNK_TILES):
            continue
        key = (not filled(blocks * s), -(-blocks * s // sms) * (per + F32_BLOCK_TILES), s)
        best = key if best is None else min(best, key)
    return best[2]


def f32_scratch_numel(b: int, sk: int, h: int, d: int) -> int:
    """Floats of the float32 core's scratch: k's and v's big and small
    parts, each B H Skp Dp (keys padded to whole 64-key tiles, columns to
    whole panels)."""
    keys = -(-sk // F32_KEY_TILE) * F32_KEY_TILE
    return 4 * b * h * keys * -(-d // F32_PANEL) * F32_PANEL


def f32_workspace_numel(splits: int, b: int, sq: int, h: int, d: int) -> int:
    """Floats of the float32 core's workspace at s = ``splits`` > 1: each
    chunk's unnormalised output, running max and row sum of every row."""
    return splits * b * h * sq * (d + 2)


@functools.lru_cache(maxsize=None)
def _multiprocessors(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def f32_core(q: int, k: int, v: int, out: int, lse, b: int, sq: int, sk: int, h: int,
              d: int, q_pitch: int, kv_pitch: int, out_pitch: int, transposed: bool,
              vec: bool, device) -> int:
    """One float32 attention call of csrc/flash_f32.cu on data pointers (the
    form's layout: natural, pitches in floats; transposed, pitch B * S):
    the split pre-pass into scratch, the core over ``f32_key_splits`` key
    chunks and, where there are more than one, the combine, on PyTorch's
    current stream; the scratch and the workspace from PyTorch.  ``lse``: a
    pointer or None.  Counts the pre-pass and the combine in
    ``f32_core.prepass_launches`` and ``combine_launches``.  Returns s."""
    splits = f32_key_splits(b, sq, sk, h, d, _multiprocessors(device))
    scratch = torch.empty((f32_scratch_numel(b, sk, h, d),), dtype=torch.float32,
                          device=device)
    ws = torch.empty((f32_workspace_numel(splits, b, sq, h, d),), dtype=torch.float32,
                     device=device) if splits > 1 else None
    lib = native.library()
    stream = native.stream_handle(device)
    lib.call("gswm_flash_f32_prepass", k, v, scratch.data_ptr(), b, sk, h, d, kv_pitch,
             int(transposed), stream)
    f32_core.prepass_launches += 1
    lib.call("gswm_flash_f32_core", q, scratch.data_ptr(), out, lse,
             None if ws is None else ws.data_ptr(), b, sq, sk, h, d, q_pitch, out_pitch,
             int(transposed), int(vec), splits, stream)
    if ws is not None:
        lib.call("gswm_flash_f32_combine", ws.data_ptr(), out, lse, b, sq, h, d, out_pitch,
                 int(transposed), splits, stream)
        f32_core.combine_launches += 1
    return splits


# the launches of the steps around the core (the core's own count on the
# wrappers' float32 counters)
f32_core.prepass_launches = 0
f32_core.combine_launches = 0


def route_self_attention(seq: int, head_dim: int = HEAD_DIM, sharded: bool = False) -> str:
    """The self-attention tier for ``seq`` tokens of ``head_dim``-wide heads,
    in the JAX package's order (``gswm.models.layers.Attention``,
    layers.py:388-535): xf -> cres -> packed -> transposed -> fused_qkv ->
    split -> plain.  ``sharded``: the layer runs under a mesh whose tp or sp
    axis is larger than 1 (``sharding.shard_params`` sets it), where the JAX
    package's mesh gates (``_use_fused_qkv`` layers.py:251-257, ``_use_xf``
    :280-286, ``_use_cres`` :309-315, ``_use_packed`` :340-346,
    ``_use_transposed`` :374-380) refuse every tier but split and plain:
    heads or the sequence are sharded, which only the split layout serves.
    Switches are read from the environment at call time, under the JAX names
    and defaults:

      xf          GSWM_XF_ATTN (on), S >= GSWM_XF_ATTN_MIN_SEQ (2305)
      cres        GSWM_CRES_ATTN (on), S >= GSWM_CRES_ATTN_MIN_SEQ (2305)
      packed      GSWM_PACKED_ATTN=1, head_dim 64,
                  S >= GSWM_PACKED_ATTN_MIN_SEQ (2305)
      transposed  GSWM_TRANSPOSED_ATTN=1, head_dim as ``kernel_head_dim``
                  takes it, S >= GSWM_TRANSPOSED_ATTN_MIN_SEQ (2305)
      fused_qkv   GSWM_FUSED_QKV not 0, 256 <= S <= GSWM_FUSED_QKV_MAX_SEQ
                  (2304)
      split       S >= GSWM_FLASH_MIN_SEQ (1024)
      plain       otherwise

    xf and cres both run ``flash_attention`` (K2): the port has one kernel
    for the natural-layout function.  The JAX gates that hold a TPU's memory
    and tiling, not what a tier computes, are dropped, since every tier
    computes the same function and the Hopper kernels have no 16 MB VMEM
    ceiling.  So the port's route differs from the JAX package's where:

      * ``cres_attention_fits`` fails (9216 tokens at 768x768): the JAX
        package falls through, the port takes cres;
      * ``packed_attention_fits`` fails (16384 tokens): likewise for packed.
        GSWM_PACKED_ATTN_MAX_SEQ only widens that gate, so it changes no
        route here;
      * ``transposed_attention_fits`` fails: always below a batch of 8 (the
        TPU's 8-sublane DMA), so at every batch sd-2-1 runs, and at sd-1-4's
        batch 4 (its batch 8 under guidance passes the gate, and both
        packages take transposed there); the JAX package also refuses
        head_dim % 8 != 0, and so does ``kernel_takes_head_dim``;
      * ``fused_qkv_attention_fits`` fails (576 tokens at 1280 channels,
        768x768 level 2): the JAX package takes the split or plain path,
        the port K1.

    The JAX package's other gates have no counterpart: ``on_device`` (the
    port's wrappers pick kernel or plain version by the tensor's device)
    and the bias check (the port's q/k/v projections are bias-free).  The
    mesh gates read the layer's own record (``sharded``) instead of an
    ambient mesh.  Ignored, because they change only the TPU
    tiling or pick a variant that is no parity target: GSWM_FUSED_QKV_MODE
    (all-heads K1 or seqhead K5, one function, which K1 serves),
    GSWM_PACKED_TIER, GSWM_SELF_PROJ, GSWM_ATTN_USE_MAX, GSWM_XF_BF16_EXP,
    GSWM_ATTN_EXP2 and GSWM_ATTN_PV_CHUNKS."""
    if sharded:
        return "split" if seq >= _seq_switch("GSWM_FLASH_MIN_SEQ", FLASH_MIN_SEQ) else "plain"
    if os.environ.get("GSWM_XF_ATTN", "1") == "1" and \
            seq >= _seq_switch("GSWM_XF_ATTN_MIN_SEQ", TIER_MIN_SEQ):
        return "xf"
    if os.environ.get("GSWM_CRES_ATTN", "1") == "1" and \
            seq >= _seq_switch("GSWM_CRES_ATTN_MIN_SEQ", TIER_MIN_SEQ):
        return "cres"
    if os.environ.get("GSWM_PACKED_ATTN", "0") == "1" and head_dim == HEAD_DIM and \
            seq >= _seq_switch("GSWM_PACKED_ATTN_MIN_SEQ", TIER_MIN_SEQ):
        return "packed"
    if os.environ.get("GSWM_TRANSPOSED_ATTN", "0") == "1" and \
            kernel_takes_head_dim(head_dim) and \
            seq >= _seq_switch("GSWM_TRANSPOSED_ATTN_MIN_SEQ", TIER_MIN_SEQ):
        return "transposed"
    if os.environ.get("GSWM_FUSED_QKV", "1") != "0" and FUSED_QKV_MIN_SEQ <= seq <= \
            _seq_switch("GSWM_FUSED_QKV_MAX_SEQ", FUSED_QKV_MAX_SEQ):
        return "fused_qkv"
    if seq >= _seq_switch("GSWM_FLASH_MIN_SEQ", FLASH_MIN_SEQ):
        return "split"
    return "plain"


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              heads: int) -> torch.Tensor:
    """Plain version: (B, S, H*D) q/k/v -> (B, S, H*D), exact softmax in fp32,
    cast back to q's dtype (``gswm.ops.attention.reference_attention``);
    ``flash_attention_split_reference`` on the (B, S, H, D) view."""
    b, s, inner = q.shape

    def split(t):  # (B, S, H*D) -> (B, S, H, D)
        return t.reshape(b, t.shape[1], heads, inner // heads)

    return flash_attention_split_reference(split(q), split(k), split(v)).reshape(
        b, s, inner)


def fused_qkv_attention_reference(x: torch.Tensor, wq: torch.Tensor,
                                  wk: torch.Tensor, wv: torch.Tensor,
                                  heads: int) -> torch.Tensor:
    """Plain version: (B, S, C) x and (H*D, C) weights -> (B, S, H*D), all in
    fp32, cast back to x's dtype."""
    xf = x.to(torch.float32)

    def proj(w):
        return torch.matmul(xf, w.to(torch.float32).t())

    out = flash_attention_reference(proj(wq), proj(wk), proj(wv), heads)
    return out.to(x.dtype)


def _check_cuda(name: str, dtypes: tuple, *tensors: torch.Tensor) -> torch.dtype:
    """What a CUDA kernel takes: tensors on one device, all of one dtype
    among ``dtypes`` (the kernel's), contiguous and 16-byte aligned.
    Returns the dtype."""
    dev, dtype = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype not in dtypes or t.dtype != dtype:
            raise TypeError(f"{name}: the CUDA kernel takes "
                            f"{' or '.join(map(str, dtypes))}, one for all tensors; got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the CUDA kernel needs 16-byte aligned data")
    return dtype


def _flash_entry(dtype: torch.dtype, d: int, lse: bool = False) -> str:
    """The C entry of the flash kernel ``dtype_kernel`` names (which raises
    where there is none): ``gswm_flash_f32_core`` in float32 (with the
    log-sum-exp or without: a pointer; ``f32_core`` runs it between the
    pre-pass and the combine), else ``gswm_flash_split``, with ``lse`` its
    ``_lse`` entry.  Each dispatches on d."""
    dtype_kernel(dtype, d)
    if dtype == torch.float32:
        return "gswm_flash_f32_core"
    return "gswm_flash_split_lse" if lse else "gswm_flash_split"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """(B, S, H*D) q/k/v -> (B, S, H*D) self-attention output.

    CPU: ``flash_attention_reference``.  CUDA: the kernel ``dtype_kernel``
    names on the (B, S, H, D) view, any S: in bf16 csrc/flash_hopper.cu,
    flash_mid.cu or flash_split.cu at any D ``kernel_takes_head_dim``
    takes, in float32 csrc/flash_f32.cu's three steps at the same D
    (``f32_core``)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, heads)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    native.refuse_grad("flash_attention", q, k, v)
    dtype = _check_cuda("flash_attention", KERNEL_DTYPES, q, k, v)
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q/k/v shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} must be equal (B, S, H*D)")
    b, s, inner = q.shape
    if inner % heads:
        raise ValueError(f"flash_attention: inner {inner} is not heads {heads} x D")
    d = inner // heads
    entry = _flash_entry(dtype, d)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        if dtype == torch.float32:
            f32_core(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, b, s, s,
                      heads, d, inner, inner, inner, False, True, q.device)
        else:
            native.library().call(entry, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  out.data_ptr(), b, s, s, heads, d,
                                  native.stream_handle(q.device))
    _count(flash_attention, d, dtype)
    return out


flash_attention.launches = 0
flash_attention.launches_by_d = {}
flash_attention.launches_f32 = 0
flash_attention.launches_f32_by_d = {}


def _check_projection(name: str, x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                      wv: torch.Tensor, inner: int) -> tuple[int, int, int, torch.dtype]:
    """What the projection GEMMs take: CUDA (B, S, C) x and (inner, C)
    weights, all bf16 (csrc/fused_qkv.cu) or all float32
    (csrc/qkv_proj_f32.cu), C and inner multiples of 64.  Returns (B, S, C,
    dtype)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    native.refuse_grad(name, x, wq, wk, wv)
    dtype = _check_cuda(name, KERNEL_DTYPES, x, wq, wk, wv)
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (B, S, C), got {tuple(x.shape)}")
    b, s, c = x.shape
    for w in (wq, wk, wv):
        if tuple(w.shape) != (inner, c):
            raise ValueError(f"{name}: weight {tuple(w.shape)} != ({inner}, {c})")
    if c % 64 or inner % 64:
        raise ValueError(f"{name}: channels {c} and width {inner} must be "
                         "multiples of 64")
    return b, s, c, dtype


def qkv_projection_reference(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                             wv: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Plain version: (B, S, C) x and (N, C) weights -> q, k, v (B, S, N),
    x @ w.T in fp32, cast back to x's dtype."""
    xf = x.to(torch.float32)
    return tuple(torch.matmul(xf, w.to(torch.float32).t()).to(x.dtype)
                 for w in (wq, wk, wv))


def qkv_projection(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                   wv: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """(B, S, C) x and bias-free (N, C) q/k/v weights -> q, k, v (B, S, N):
    the projection step of ``fused_qkv_attention`` on its own.

    CPU: ``qkv_projection_reference``.  CUDA (C % 64 == 0, N % 64 == 0, any
    B * S): in bf16 the GEMM of csrc/fused_qkv.cu (fp32 accumulation), in
    float32 that of csrc/qkv_proj_f32.cu."""
    if x.device.type == "cpu":
        return qkv_projection_reference(x, wq, wk, wv)
    inner = wq.shape[0]
    b, s, c, dtype = _check_projection("qkv_projection", x, wq, wk, wv, inner)
    q, k, v = (x.new_empty((b, s, inner)) for _ in range(3))
    lib = native.library()
    f32 = dtype == torch.float32
    with torch.cuda.device(x.device):
        lib.call("gswm_qkv_proj_f32" if f32 else "gswm_qkv_proj", x.data_ptr(),
                 wq.data_ptr(), wk.data_ptr(), wv.data_ptr(), q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), b * s, c, inner, native.stream_handle(x.device))
    if f32:
        qkv_projection.launches_f32 += 1
    else:
        qkv_projection.launches += 1
    return q, k, v


qkv_projection.launches = 0
qkv_projection.launches_f32 = 0


def fused_qkv_attention(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                        wv: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, C) x and bias-free (H*D, C) q/k/v weights -> (B, S, H*D).

    CPU: ``fused_qkv_attention_reference``.  CUDA (C and H*D multiples of
    64): in bf16 the projection GEMM of csrc/fused_qkv.cu, then the kernel
    ``head_dim_kernel`` names (csrc/flash_hopper.cu, flash_mid.cu or
    flash_split.cu; any D ``kernel_takes_head_dim`` takes), one C call; in
    float32 the GEMM of csrc/qkv_proj_f32.cu, then csrc/flash_f32.cu's
    three steps (``f32_core``)."""
    if x.device.type == "cpu":
        return fused_qkv_attention_reference(x, wq, wk, wv, heads)
    inner = wq.shape[0]
    if inner % heads:
        raise ValueError(f"fused_qkv_attention: width {inner} is not heads {heads} x D")
    d = inner // heads
    b, s, c, dtype = _check_projection("fused_qkv_attention", x, wq, wk, wv, inner)
    _flash_entry(dtype, d)  # raises where no kernel takes the dtype or d
    q, k, v, out = (x.new_empty((b, s, inner)) for _ in range(4))
    lib = native.library()
    ptrs = [t.data_ptr() for t in (x, wq, wk, wv, q, k, v)]
    with torch.cuda.device(x.device):
        stream = native.stream_handle(x.device)
        if dtype == torch.float32:
            lib.call("gswm_qkv_proj_f32", *ptrs, b * s, c, inner, stream)
            f32_core(*ptrs[4:], out.data_ptr(), None, b, s, s, heads, d, inner, inner, inner,
                      False, True, x.device)
        else:
            lib.call("gswm_fused_qkv_attn", *ptrs, out.data_ptr(), b, s, c, heads, d,
                     stream)
    _count(fused_qkv_attention, d, dtype)
    return out


fused_qkv_attention.launches = 0
fused_qkv_attention.launches_by_d = {}
fused_qkv_attention.launches_f32 = 0
fused_qkv_attention.launches_f32_by_d = {}

# gswm/ops/attention.py:443: fewer keys than this (cross-attention's 77) take
# the einsum path; the blockwise kernel starts here.
SPLIT_MIN_KEYS = 512


def flash_attention_split_reference(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor) -> torch.Tensor:
    """Plain version: (B, Sq, H, D) q, (B, Sk, H, D) k/v -> (B, Sq, H, D);
    matmul, exact softmax and matmul in fp32, cast back to q's dtype."""
    d = q.shape[-1]
    qf, kf, vf = (t.to(torch.float32).transpose(1, 2) for t in (q, k, v))
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * (d**-0.5)
    out = torch.matmul(torch.softmax(logits, dim=-1), vf)
    return out.transpose(1, 2).contiguous().to(q.dtype)


def flash_attention_split_lse_reference(q: torch.Tensor, k: torch.Tensor,
                                        v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the log-sum-exp variant: (B, Sq, H, D) q, (B, Sk, H, D)
    k/v -> (out (B, Sq, H, D) in q's dtype, lse (B, H, Sq) fp32); fp32
    matmul, ``torch.logsumexp`` of the logits q k^T d^-0.5 (natural log),
    softmax and matmul."""
    d = q.shape[-1]
    qf, kf, vf = (t.to(torch.float32).transpose(1, 2) for t in (q, k, v))
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * (d**-0.5)
    lse = torch.logsumexp(logits, dim=-1)
    out = torch.matmul(torch.softmax(logits, dim=-1), vf)
    return out.transpose(1, 2).contiguous().to(q.dtype), lse


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain model of the kernels' operand split (csrc/hopper.cuh
    split_tf32): float32 x -> (big, small), big = x rounded to TF32 (10
    explicit mantissa bits, to nearest, ties away from zero: cvt.rna),
    small = x - big rounded the same way; both float32 tensors."""

    def rna(t):
        bits = t.contiguous().view(torch.int32)
        sign = bits & -0x80000000
        mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
        return (sign | mag).view(torch.float32)

    x = x.to(torch.float32)
    big = rna(x)
    return big, rna(x - big)


def _products_3xtf32(a, b, passes: int) -> torch.Tensor:
    """a @ b of split operands ((big, small) pairs), the float32 sums of
    small * big, big * small and big * big (``passes`` = 3) or big * big
    alone (1: one TF32 product; 0, where the pairs hold the unsplit
    operands: the plain fp32 product)."""
    terms = [(a[1], b[0]), (a[0], b[1])] if passes == 3 else []
    out = None
    for x, y in terms + [(a[0], b[0])]:
        prod = torch.matmul(x, y)
        out = prod if out is None else out + prod
    return out


def flash_attention_3xtf32_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                     splits: int = 1, passes: int = 3,
                                     return_lse: bool = False):
    """Model of csrc/flash_f32.cu's arithmetic on (B, Sq, H, D) q and (B, Sk,
    H, D) k, v: every product from ``split_tf32``'s parts
    (``_products_3xtf32``; ``passes`` = 1: one-pass TF32; 0: plain fp32
    products, the key split's algebra alone), each key tile's
    logits summed a 64-column panel at a time and the panels added in fp32,
    the online softmax tile by tile in fp32, each tile's p v summed apart
    and added, the keys in ``splits`` chunks of whole tiles merged as the
    combine merges them.  Returns (B, Sq, H, D) float32 (and, with
    ``return_lse``, lse (B, H, Sq)).  The tests predict the kernel's error
    with it; the card's path never calls it."""
    d = q.shape[-1]
    c = torch.tensor(1.4426950408889634 / d**0.5, dtype=torch.float32).item()
    qf, kf, vf = (t.to(torch.float32).transpose(1, 2) for t in (q, k, v))
    sk = kf.shape[2]
    tiles = -(-sk // F32_KEY_TILE)
    per = -(-tiles // splits)
    split = split_tf32 if passes else (lambda t: (t, None))
    qs = split(qf)
    partials = []
    for t0 in range(0, tiles, per):
        shape = qf.shape[:3]
        m = torch.full(shape, -torch.inf, device=qf.device)
        l = torch.zeros(shape, device=qf.device)
        o = torch.zeros(qf.shape, device=qf.device)
        for t in range(t0, min(tiles, t0 + per)):
            keys = slice(t * F32_KEY_TILE, (t + 1) * F32_KEY_TILE)
            kt = split(kf[:, :, keys])
            s = None
            for j in range(0, d, F32_PANEL):
                cols = slice(j, j + F32_PANEL)
                part = _products_3xtf32(
                    [x if x is None else x[..., cols] for x in qs],
                    [x if x is None else x[..., cols].transpose(-1, -2) for x in kt], passes)
                s = part if s is None else s + part
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp2((m - m_new) * c)
            p = torch.exp2(s * c - (m_new * c)[..., None])
            l = l * alpha + p.sum(dim=-1)
            o = o * alpha[..., None] + _products_3xtf32(split(p), split(vf[:, :, keys]),
                                                        passes)
            m = m_new
        partials.append((o, m, l))
    top = torch.stack([m for _, m, _ in partials]).amax(dim=0)
    weights = [torch.exp2((m - top) * c) for _, m, _ in partials]
    total = sum(l * w for (_, _, l), w in zip(partials, weights))
    out = sum(o * w[..., None] for (o, _, _), w in zip(partials, weights)) / total[..., None]
    out = out.transpose(1, 2).contiguous()
    if return_lse:
        return out, top * c * math.log(2.0) + torch.log(total)
    return out


def f32_prepass_reference(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version of the float32 core's split pre-pass on (B, Sk, H, D) k
    and v: the scratch it writes, flat, ``f32_scratch_numel`` floats: k's big
    and small parts as (B, H, Skp, Dp) [key][column] rows, then v's as (B,
    H, Dp, Skp) [column][key] rows with the keys of each group of 8 in the
    order 0, 2, 4, 6, 1, 3, 5, 7; zeros past Sk and D."""
    b, sk, h, d = k.shape
    keys = -(-sk // F32_KEY_TILE) * F32_KEY_TILE
    cols = -(-d // F32_PANEL) * F32_PANEL

    def padded(t):  # (B, H, Skp, Dp), zeros past Sk and D
        out = t.new_zeros((b, h, keys, cols), dtype=torch.float32)
        out[:, :, :sk, :d] = t.transpose(1, 2)
        return out

    order = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])
    perm = (torch.arange(keys) // 8 * 8).view(-1, 8) + order
    kp, vp = padded(k), padded(v)[:, :, perm.reshape(-1)].transpose(-1, -2)
    parts = [*split_tf32(kp), *split_tf32(vp)]
    return torch.cat([t.reshape(-1) for t in parts])


def f32_combine_reference(ws: torch.Tensor, splits: int, b: int, sq: int, h: int,
                          d: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the combine on the core's workspace (``splits``
    chunks: partial outputs [s][B H][Sq][D], then the running maxima and the
    row sums [s][B H][Sq]): (out (B, Sq, H, D), lse (B, H, Sq)), each chunk
    weighted by exp2((m_i - M) c), c = d^-0.5 log2(e), M the largest m_i."""
    rows = b * h * sq
    o = ws[:splits * rows * d].view(splits, b, h, sq, d)
    m = ws[splits * rows * d:splits * rows * (d + 1)].view(splits, b, h, sq)
    l = ws[splits * rows * (d + 1):splits * rows * (d + 2)].view(splits, b, h, sq)
    c = torch.tensor(1.4426950408889634 / d**0.5, dtype=torch.float32).item()
    top = m.amax(dim=0)
    w = torch.exp2((m - top) * c)
    total = (l * w).sum(dim=0)
    out = (o * w[..., None]).sum(dim=0) / total[..., None]
    return out.transpose(1, 2).contiguous(), top * c * math.log(2.0) + torch.log(total)


def flash_attention_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          return_lse: bool = False):
    """(B, Sq, H, D) q, (B, Sk, H, D) k/v -> (B, Sq, H, D) attention output;
    with ``return_lse`` also each row's log-sum-exp of the logits q k^T
    d^-0.5, fp32 (B, H, Sq), natural log: what merges partial outputs over
    disjoint key sets (``ops.ring_attention``).

    The counterpart of ``gswm.ops.attention.flash_attention`` (this module's
    ``flash_attention`` is the natural-layout wrapper).  Below
    ``SPLIT_MIN_KEYS`` keys: the reference's einsum path (matmul in the input dtype, softmax in
    fp32, probabilities cast back; lse of the same fp32 logits).  Otherwise
    CPU: the plain versions; CUDA: the kernel ``dtype_kernel`` names, any Sq
    and Sk: in bf16 csrc/flash_hopper.cu up to D = 64, flash_mid.cu to 160,
    flash_split.cu above, any D ``kernel_takes_head_dim`` takes
    (``gswm_flash_split_lse`` with ``return_lse``); in float32
    csrc/flash_f32.cu's three steps at the same D (``f32_core``, the core
    and the combine writing the lse with ``return_lse``).
    Launches with lse count in ``flash_attention_split.lse_launches`` (and
    ``lse_launches_by_d``; float32: ``lse_launches_f32[_by_d]``), the
    others in float32 in ``launches_f32`` (and ``launches_f32_by_d``), in
    bf16 in ``launches``."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"flash_attention_split: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         "(B, Sq, H, D) and (B, Sk, H, D)")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if sk < SPLIT_MIN_KEYS:
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (d**-0.5)
        logits = logits.to(torch.float32)
        out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1).to(q.dtype), v)
        return (out, torch.logsumexp(logits, dim=-1)) if return_lse else out
    if q.device.type == "cpu":
        if return_lse:
            return flash_attention_split_lse_reference(q, k, v)
        return flash_attention_split_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_split: unsupported device {q.device}")
    native.refuse_grad("flash_attention_split", q, k, v)
    dtype = _check_cuda("flash_attention_split", KERNEL_DTYPES, q, k, v)
    entry = _flash_entry(dtype, d, return_lse)
    out = torch.empty_like(q)
    lib = native.library()
    with torch.cuda.device(q.device):
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
            if return_lse else None
        if dtype == torch.float32:
            f32_core(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      None if lse is None else lse.data_ptr(), b, sq, sk, h, d, h * d, h * d,
                      h * d, False, True, q.device)
        elif return_lse:
            lib.call(entry, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     lse.data_ptr(), b, sq, sk, h, d, native.stream_handle(q.device))
        else:
            lib.call(entry, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
                     sk, h, d, native.stream_handle(q.device))
    if return_lse:
        _count(flash_attention_split, d, dtype, "lse_launches")
        return out, lse
    _count(flash_attention_split, d, dtype)
    return out


flash_attention_split.launches = 0
flash_attention_split.launches_by_d = {}
flash_attention_split.launches_f32 = 0
flash_attention_split.launches_f32_by_d = {}
flash_attention_split.lse_launches = 0
flash_attention_split.lse_launches_by_d = {}
flash_attention_split.lse_launches_f32 = 0
flash_attention_split.lse_launches_f32_by_d = {}


def flash_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            mesh=None) -> torch.Tensor:
    """``flash_attention_split`` partitioned over a mesh
    (``sharding.make_mesh``): the counterpart of
    ``gswm.ops.attention.flash_attention_sharded`` (attention.py:1491).
    q, k, v are the whole (B, S, H, D) tensors, the same on every rank;
    every rank returns the whole output.

      * sp > 1 dividing both sequences: ``ops.ring_attention`` (the
        sequence is the axis worth sharding once a latent outgrows a card);
      * else tp > 1 dividing the heads: this rank's heads (and, where dp
        divides the batch, its batch rows) through the kernel, no collective
        inside, then an all_gather over tp (and dp) assembles the output;
      * else, and without a mesh: ``flash_attention_split`` on the whole
        tensors, where the JAX function falls back (attention.py:1508-1523)."""
    from gswm_torch.sharding import mesh as meshes

    if mesh is None:
        return flash_attention_split(q, k, v)
    sp = meshes.axis_size(mesh, "sp")
    if sp > 1 and q.shape[1] % sp == 0 and k.shape[1] % sp == 0:
        from gswm_torch.ops.ring_attention import ring_attention

        return ring_attention(q, k, v, mesh)
    tp = meshes.axis_size(mesh, "tp")
    if tp == 1 or q.shape[2] % tp:
        return flash_attention_split(q, k, v)
    by_dp = meshes.batch_divisible(mesh, q.shape[0])
    q, k, v = (meshes.shard_dim(t, mesh, "tp", 2) for t in (q, k, v))
    if by_dp:
        q, k, v = (meshes.shard_batch(t, mesh) for t in (q, k, v))
    out = meshes.gather_dim(flash_attention_split(q, k, v), mesh, "tp", 2)
    return meshes.gather_batch(out, mesh) if by_dp else out


def flash_attention_packed_reference(qkv: torch.Tensor) -> torch.Tensor:
    """Plain version: (B, S, 3*P*128) pair-packed qkv -> (B, S, P*128).  q, k
    and v are the lane groups [0, P*128), [P*128, 2P*128) and [2P*128,
    3P*128), each (B, S, 2P, 64) heads; ``flash_attention_split_reference``
    on those views.  A zero pad head gives zero output."""
    b, s, c3 = qkv.shape
    pc = c3 // 3
    q, k, v = (t.reshape(b, s, pc // HEAD_DIM, HEAD_DIM) for t in qkv.split(pc, dim=-1))
    return flash_attention_split_reference(q, k, v).reshape(b, s, pc)


def flash_attention_packed(qkv: torch.Tensor) -> torch.Tensor:
    """(B, S, 3*P*128) pair-packed qkv -> (B, S, P*128) self-attention output:
    the counterpart of ``gswm.ops.attention.flash_attention_packed`` at
    head_dim 64, whose lane layout is two d = 64 heads per 128 columns (odd
    head counts zero-pad the projection weights).

    CPU: ``flash_attention_packed_reference``.  CUDA, any S: in bf16 the
    kernel of csrc/flash_hopper.cu reading q, k and v as strided (B, S, 2P,
    64) views of the one array; in float32 csrc/flash_f32.cu's natural-layout
    steps on the same views (``f32_core`` with the array's row pitches)."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * 128):
        raise ValueError(f"flash_attention_packed: qkv {tuple(qkv.shape)} is not "
                         "(B, S, 3 * P * 128)")
    if qkv.device.type == "cpu":
        return flash_attention_packed_reference(qkv)
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_attention_packed: unsupported device {qkv.device}")
    native.refuse_grad("flash_attention_packed", qkv)
    dtype = _check_cuda("flash_attention_packed", KERNEL_DTYPES, qkv)
    b, s, c3 = qkv.shape
    pairs = c3 // (3 * 128)
    out = qkv.new_empty((b, s, pairs * 128))
    with torch.cuda.device(qkv.device):
        if dtype == torch.float32:  # q, k, v: the column bands, 2 P heads of 64 each
            base, width = qkv.data_ptr(), pairs * 128
            f32_core(base, base + 4 * width, base + 8 * width, out.data_ptr(), None, b, s, s,
                      2 * pairs, HEAD_DIM, 3 * width, 3 * width, width, False, True,
                      qkv.device)
        else:
            native.library().call("gswm_flash_packed", qkv.data_ptr(), out.data_ptr(), b, s,
                                  pairs, native.stream_handle(qkv.device))
    _count(flash_attention_packed, HEAD_DIM, dtype)
    return out


flash_attention_packed.launches = 0
flash_attention_packed.launches_by_d = {}
flash_attention_packed.launches_f32 = 0
flash_attention_packed.launches_f32_by_d = {}


def flash_attention_transposed_reference(qkv_t: torch.Tensor,
                                         heads: int) -> torch.Tensor:
    """Plain version: (3*H*D, B, S) transposed qkv -> (H*D, B, S); q, k and v
    are the row bands [0, H*D), [H*D, 2H*D) and [2H*D, 3H*D), head h at rows
    h*D..h*D+D of its band.  ``flash_attention_split_reference`` on the
    (B, S, H, D) views."""
    n3, b, s = qkv_t.shape
    d = n3 // (3 * heads)
    q, k, v = qkv_t.reshape(3, heads, d, b, s).permute(0, 3, 4, 1, 2)
    out = flash_attention_split_reference(q, k, v)  # (B, S, H, D)
    return out.permute(2, 3, 0, 1).reshape(heads * d, b, s)


def flash_attention_transposed(qkv_t: torch.Tensor, heads: int) -> torch.Tensor:
    """(3*H*D, B, S) qkv, the native output of the ('nc,bsc->nbs') projection,
    -> (H*D, B, S), which ``to_out`` contracts over dim 0: the counterpart of
    ``gswm.ops.attention.flash_attention_transposed``.

    CPU: ``flash_attention_transposed_reference`` (any D).  CUDA, D as
    ``kernel_head_dim`` takes it, any B and S, the kernel
    ``transposed_kernel`` names: in bf16 csrc/flash_transposed.cu's
    launcher and the design of D (flash_hopper.cu's narrow kernel at D <=
    48, flash_mid.cu's at 64 < D <= 160 and flash_split.cu's above, with
    the transposed layout, flash_transposed.cu's own at 64), all on wgmma,
    its boxes moved by TMA where S % 8 == 0 and, elsewhere, by hand to D =
    160 and above it by TMA over scratch of an aligned token pitch (the C
    entry's pre-pass, the output by hand; the pre-pass counts in
    ``flash_attention_transposed.align_launches``); in float32
    csrc/flash_f32.cu's steps with the transposed layout (``f32_core``:
    q by 16-byte copies where S % 4 == 0, 4-byte ones elsewhere).  Launches also count by kernel, in
    ``flash_attention_transposed.launches_by_kernel``."""
    if qkv_t.dim() != 3 or qkv_t.shape[0] % (3 * heads):
        raise ValueError(f"flash_attention_transposed: qkv_t {tuple(qkv_t.shape)} "
                         f"is not (3 * {heads} * D, B, S)")
    if qkv_t.device.type == "cpu":
        return flash_attention_transposed_reference(qkv_t, heads)
    if qkv_t.device.type != "cuda":
        raise ValueError(f"flash_attention_transposed: unsupported device {qkv_t.device}")
    native.refuse_grad("flash_attention_transposed", qkv_t)
    dtype = _check_cuda("flash_attention_transposed", KERNEL_DTYPES, qkv_t)
    n3, b, s = qkv_t.shape
    d = n3 // (3 * heads)
    kernel = transposed_kernel(d, s, dtype)
    out = qkv_t.new_empty((heads * d, b, s))
    with torch.cuda.device(qkv_t.device):
        if dtype == torch.float32:  # q, k, v: the row bands, B * S floats between columns
            base, band = qkv_t.data_ptr(), heads * d * b * s
            f32_core(base, base + 4 * band, base + 8 * band, out.data_ptr(), None, b, s, s,
                      heads, d, b * s, b * s, b * s, True, s % 4 == 0, qkv_t.device)
        else:
            native.launch(qkv_t.device, "gswm_flash_transposed", qkv_t.data_ptr(),
                          out.data_ptr(), b, s, heads, d)
            flash_attention_transposed.align_launches += kernel.endswith(ALIGNED_FORM)
    _count(flash_attention_transposed, d, dtype)
    by_kernel = flash_attention_transposed.launches_by_kernel
    by_kernel[kernel] = by_kernel.get(kernel, 0) + 1
    return out


flash_attention_transposed.launches = 0
flash_attention_transposed.launches_by_d = {}
flash_attention_transposed.launches_f32 = 0
flash_attention_transposed.launches_f32_by_d = {}
flash_attention_transposed.launches_by_kernel = {}
flash_attention_transposed.align_launches = 0

