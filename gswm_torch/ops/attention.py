"""Self-attention kernels of the PyTorch port, with their plain versions.

Four kernels, hand-written CUDA for Hopper (``gswm_torch/csrc``), all on
wgmma + TMA, behind six wrappers; ``route_self_attention`` picks the UNet's
tier as the JAX package does.  Every layout but the pair-packed one takes
any head dim d with d % 8 == 0 up to 512 (``kernel_head_dim``): in the
natural, split and fused-qkv layouts every d <= 64 runs the kernels of
csrc/flash_hopper.cu (its narrow one at d <= 48), every wider d the kernel
of csrc/flash_split.cu at d rounded up to a multiple of 64; the transposed
layout has the same split at 64 in csrc/flash_transposed.cu; the kernels'
tensor maps zero-fill the columns (transposed: rows) past d (SD 1.x: 40, 80,
160):

  * ``flash_attention_split`` — split-layout flash attention on
    (B, S, H, D) q/k/v: csrc/flash_hopper.cu up to D = 64,
    csrc/flash_split.cu (D split across two consumer warpgroups) above.
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
    tiles read as they lie (MN-major q and k); D split across two consumer
    warpgroups above 64.  Port of the Pallas
    ``flash_attention_transposed``; the ``transposed`` route.  Where S is
    no multiple of 8 no tensor map can address the rows, and a third,
    masked kernel (mma.sync) serves the shape.
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

On a CPU tensor each wrapper runs its plain PyTorch version; on a CUDA
tensor it launches its kernel or raises, and it raises under a gradient
(``native.refuse_grad``): no kernel has a backward.  Each wrapper counts
its launches in a plain integer attribute, ``<wrapper>.launches``, and by
head dim in a dict, ``<wrapper>.launches_by_d``.

Weights are in ``torch.nn.Linear``'s (out, in) layout: q = x @ wq.T.
"""

from __future__ import annotations

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
    """The panel width the CUDA kernels compute head dim ``d`` at: 64 for
    d <= 64 (csrc/flash_hopper.cu; the transposed layout's first kernel),
    else d rounded up to a multiple of 64 (the templates of
    csrc/flash_split.cu and of the transposed layout's split kernel, 128
    ... 512).  Raises ValueError for a d the kernels do not take
    (``kernel_takes_head_dim``)."""
    if not kernel_takes_head_dim(d):
        raise ValueError(f"head dim {d}: the attention kernels take d % 8 == 0, "
                         f"8 <= d <= {KERNEL_MAX_HEAD_DIM}")
    return max(HEAD_DIM, -(-d // 64) * 64)


def _count(wrapper, d: int) -> None:
    wrapper.launches += 1
    wrapper.launches_by_d[d] = wrapper.launches_by_d.get(d, 0) + 1


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


def _check_cuda_bf16(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the CUDA kernel takes bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the CUDA kernel needs 16-byte aligned data")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """(B, S, H*D) q/k/v -> (B, S, H*D) self-attention output.

    CPU: ``flash_attention_reference``.  CUDA: the kernel of
    csrc/flash_hopper.cu (D <= 64) or csrc/flash_split.cu on the (B, S, H, D)
    view (bf16, any S, D as ``kernel_head_dim`` takes it)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, heads)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    native.refuse_grad("flash_attention", q, k, v)
    _check_cuda_bf16("flash_attention", q, k, v)
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q/k/v shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} must be equal (B, S, H*D)")
    b, s, inner = q.shape
    if inner % heads:
        raise ValueError(f"flash_attention: inner {inner} is not heads {heads} x D")
    d = inner // heads
    kernel_head_dim(d)
    out = torch.empty_like(q)
    lib = native.library()
    with torch.cuda.device(q.device):
        lib.call("gswm_flash_split", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), b, s, s, heads, d, native.stream_handle(q.device))
    _count(flash_attention, d)
    return out


flash_attention.launches = 0
flash_attention.launches_by_d = {}


def _check_projection(name: str, x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                      wv: torch.Tensor, inner: int) -> tuple[int, int, int]:
    """What the projection GEMM takes: CUDA bf16 (B, S, C) x and (inner, C)
    weights, C and inner multiples of 64.  Returns (B, S, C)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    native.refuse_grad(name, x, wq, wk, wv)
    _check_cuda_bf16(name, x, wq, wk, wv)
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (B, S, C), got {tuple(x.shape)}")
    b, s, c = x.shape
    for w in (wq, wk, wv):
        if tuple(w.shape) != (inner, c):
            raise ValueError(f"{name}: weight {tuple(w.shape)} != ({inner}, {c})")
    if c % 64 or inner % 64:
        raise ValueError(f"{name}: channels {c} and width {inner} must be "
                         "multiples of 64")
    return b, s, c


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

    CPU: ``qkv_projection_reference``.  CUDA: the GEMM of csrc/fused_qkv.cu
    (bf16, C % 64 == 0, N % 64 == 0, fp32 accumulation, any B * S)."""
    if x.device.type == "cpu":
        return qkv_projection_reference(x, wq, wk, wv)
    inner = wq.shape[0]
    b, s, c = _check_projection("qkv_projection", x, wq, wk, wv, inner)
    q, k, v = (x.new_empty((b, s, inner)) for _ in range(3))
    lib = native.library()
    with torch.cuda.device(x.device):
        lib.call("gswm_qkv_proj", x.data_ptr(), wq.data_ptr(), wk.data_ptr(),
                 wv.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), b * s, c,
                 inner, native.stream_handle(x.device))
    qkv_projection.launches += 1
    return q, k, v


qkv_projection.launches = 0


def fused_qkv_attention(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                        wv: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, C) x and bias-free (H*D, C) q/k/v weights -> (B, S, H*D).

    CPU: ``fused_qkv_attention_reference``.  CUDA: the projection GEMM of
    csrc/fused_qkv.cu, then the kernel of csrc/flash_hopper.cu (D <= 64) or
    csrc/flash_split.cu (bf16, C and H*D multiples of 64, D as
    ``kernel_head_dim`` takes it)."""
    if x.device.type == "cpu":
        return fused_qkv_attention_reference(x, wq, wk, wv, heads)
    inner = wq.shape[0]
    if inner % heads:
        raise ValueError(f"fused_qkv_attention: width {inner} is not heads {heads} x D")
    d = inner // heads
    kernel_head_dim(d)
    b, s, c = _check_projection("fused_qkv_attention", x, wq, wk, wv, inner)
    q, k, v, out = (x.new_empty((b, s, inner)) for _ in range(4))
    lib = native.library()
    with torch.cuda.device(x.device):
        lib.call("gswm_fused_qkv_attn", x.data_ptr(), wq.data_ptr(), wk.data_ptr(),
                 wv.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), b, s, c, heads, d, native.stream_handle(x.device))
    _count(fused_qkv_attention, d)
    return out


fused_qkv_attention.launches = 0
fused_qkv_attention.launches_by_d = {}

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
    CPU: the plain versions; CUDA: the kernel of csrc/flash_hopper.cu up to
    D = 64 and of csrc/flash_split.cu above (bf16, D as ``kernel_head_dim``
    takes it, any Sq and Sk), ``gswm_flash_split_lse`` with ``return_lse``.
    Launches with lse count in ``flash_attention_split.lse_launches`` (and
    ``lse_launches_by_d``), the others in ``launches``."""
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
    _check_cuda_bf16("flash_attention_split", q, k, v)
    kernel_head_dim(d)
    out = torch.empty_like(q)
    lib = native.library()
    with torch.cuda.device(q.device):
        if return_lse:
            lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
            lib.call("gswm_flash_split_lse", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), lse.data_ptr(), b, sq, sk, h, d,
                     native.stream_handle(q.device))
        else:
            lib.call("gswm_flash_split", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), b, sq, sk, h, d, native.stream_handle(q.device))
    if return_lse:
        flash_attention_split.lse_launches += 1
        by_d = flash_attention_split.lse_launches_by_d
        by_d[d] = by_d.get(d, 0) + 1
        return out, lse
    _count(flash_attention_split, d)
    return out


flash_attention_split.launches = 0
flash_attention_split.launches_by_d = {}
flash_attention_split.lse_launches = 0
flash_attention_split.lse_launches_by_d = {}


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

    CPU: ``flash_attention_packed_reference``.  CUDA: the kernel of
    csrc/flash_hopper.cu reading q, k and v as strided (B, S, 2P, 64) views
    of the one array (bf16, any S)."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * 128):
        raise ValueError(f"flash_attention_packed: qkv {tuple(qkv.shape)} is not "
                         "(B, S, 3 * P * 128)")
    if qkv.device.type == "cpu":
        return flash_attention_packed_reference(qkv)
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_attention_packed: unsupported device {qkv.device}")
    native.refuse_grad("flash_attention_packed", qkv)
    _check_cuda_bf16("flash_attention_packed", qkv)
    b, s, c3 = qkv.shape
    pairs = c3 // (3 * 128)
    out = qkv.new_empty((b, s, pairs * 128))
    lib = native.library()
    with torch.cuda.device(qkv.device):
        lib.call("gswm_flash_packed", qkv.data_ptr(), out.data_ptr(), b, s, pairs,
                 native.stream_handle(qkv.device))
    _count(flash_attention_packed, HEAD_DIM)
    return out


flash_attention_packed.launches = 0
flash_attention_packed.launches_by_d = {}


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

    CPU: ``flash_attention_transposed_reference`` (any D).  CUDA: the kernels
    of csrc/flash_transposed.cu (bf16, D as ``kernel_head_dim`` takes it, any
    B and S: wgmma + TMA where S % 8 == 0, D split across two warpgroups
    above 64; the masked kernel elsewhere)."""
    if qkv_t.dim() != 3 or qkv_t.shape[0] % (3 * heads):
        raise ValueError(f"flash_attention_transposed: qkv_t {tuple(qkv_t.shape)} "
                         f"is not (3 * {heads} * D, B, S)")
    if qkv_t.device.type == "cpu":
        return flash_attention_transposed_reference(qkv_t, heads)
    if qkv_t.device.type != "cuda":
        raise ValueError(f"flash_attention_transposed: unsupported device {qkv_t.device}")
    native.refuse_grad("flash_attention_transposed", qkv_t)
    _check_cuda_bf16("flash_attention_transposed", qkv_t)
    n3, b, s = qkv_t.shape
    d = n3 // (3 * heads)
    kernel_head_dim(d)
    out = qkv_t.new_empty((heads * d, b, s))
    lib = native.library()
    with torch.cuda.device(qkv_t.device):
        lib.call("gswm_flash_transposed", qkv_t.data_ptr(), out.data_ptr(), b, s,
                 heads, d, native.stream_handle(qkv_t.device))
    _count(flash_attention_transposed, d)
    return out


flash_attention_transposed.launches = 0
flash_attention_transposed.launches_by_d = {}
