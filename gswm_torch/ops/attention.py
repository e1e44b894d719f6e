"""Self-attention kernels of the PyTorch port, with their plain versions.

Two kernels, hand-written CUDA for Hopper (``gswm_torch/csrc``), behind
three wrappers:

  * ``flash_attention_split`` (csrc/flash_split.cu) — split-layout flash
    attention on (B, S, H, D) q/k/v, D a multiple of 64 up to 512.  Port of
    the Pallas ``gswm.ops.attention.flash_attention``; serves the VAE
    mid-block attention above 4096 tokens (one head, D = 512).
  * ``flash_attention`` — the same kernel at D = 64 on natural-layout
    (B, S, H*64) q/k/v, which is (B, S, H, 64) memory.  Serves the UNet's
    self-attention above the fused-qkv window (level 0: 4096 tokens at
    512x512, 9216 at 768x768), where the TPU path runs
    ``gswm.ops.attention.xla_flash_attention`` (or the Pallas
    ``flash_attention_cres`` it displaced).
  * ``fused_qkv_attention`` (csrc/fused_qkv.cu, then the split kernel) —
    the bias-free q/k/v projections in a hand-written GEMM, then attention.
    Port of the Pallas ``flash_attention_fused_qkv``; serves 256..2304
    tokens (levels 1 and 2).

All compute exact softmax (the TPU kernels' ``use_max`` recurrence).  The
TPU bf16 path drops the running max and clamps logits at 60
(``_NOMAX_CLAMP``); the two agree within bf16 rounding while |logit| < 60.

On a CPU tensor each wrapper runs its plain PyTorch version; on a CUDA
tensor it launches its kernel or raises.  Each wrapper counts its launches
in a plain integer attribute, ``<wrapper>.launches``.

Weights are in ``torch.nn.Linear``'s (out, in) layout: q = x @ wq.T.
"""

from __future__ import annotations

import torch

from gswm_torch import native

HEAD_DIM = 64  # the kernels' head dim (SD 2.x and SDXL fix it at 64)

# Routing window (gswm/models/layers.py:234-289): fused-qkv for
# 256 <= S <= 2304, natural-layout flash from 2305 tokens up, plain
# matmul + softmax below.
FUSED_QKV_MIN_SEQ = 256
FUSED_QKV_MAX_SEQ = 2304
FLASH_MIN_SEQ = FUSED_QKV_MAX_SEQ + 1


def route_self_attention(seq: int) -> str:
    """'fused_qkv', 'flash' or 'plain' for a self-attention of ``seq`` tokens."""
    if FUSED_QKV_MIN_SEQ <= seq <= FUSED_QKV_MAX_SEQ:
        return "fused_qkv"
    if seq >= FLASH_MIN_SEQ:
        return "flash"
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
    """(B, S, H*64) q/k/v -> (B, S, H*64) self-attention output.

    CPU: ``flash_attention_reference``.  CUDA: the kernel of
    csrc/flash_split.cu on the (B, S, H, 64) view (bf16, any S)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, heads)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check_cuda_bf16("flash_attention", q, k, v)
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q/k/v shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} must be equal (B, S, H*D)")
    b, s, inner = q.shape
    if inner != heads * HEAD_DIM:
        raise ValueError(f"flash_attention: inner {inner} != heads {heads} x {HEAD_DIM}")
    out = torch.empty_like(q)
    lib = native.library()
    with torch.cuda.device(q.device):
        lib.call("gswm_flash_split", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), b, s, s, heads, HEAD_DIM,
                 native.stream_handle(q.device))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def fused_qkv_attention(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                        wv: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, C) x and bias-free (H*64, C) q/k/v weights -> (B, S, H*64).

    CPU: ``fused_qkv_attention_reference``.  CUDA: the projection GEMM of
    csrc/fused_qkv.cu, then the split kernel (bf16, C % 64 == 0)."""
    if x.device.type == "cpu":
        return fused_qkv_attention_reference(x, wq, wk, wv, heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused_qkv_attention: unsupported device {x.device}")
    _check_cuda_bf16("fused_qkv_attention", x, wq, wk, wv)
    if x.dim() != 3:
        raise ValueError(f"fused_qkv_attention: x must be (B, S, C), got {tuple(x.shape)}")
    b, s, c = x.shape
    inner = heads * HEAD_DIM
    for w in (wq, wk, wv):
        if tuple(w.shape) != (inner, c):
            raise ValueError(f"fused_qkv_attention: weight {tuple(w.shape)} != "
                             f"({inner}, {c})")
    if c % 64:
        raise ValueError(f"fused_qkv_attention: channels {c} not a multiple of 64")
    q, k, v, out = (x.new_empty((b, s, inner)) for _ in range(4))
    lib = native.library()
    with torch.cuda.device(x.device):
        lib.call("gswm_fused_qkv_attn", x.data_ptr(), wq.data_ptr(), wk.data_ptr(),
                 wv.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), b, s, c, heads, native.stream_handle(x.device))
    fused_qkv_attention.launches += 1
    return out


fused_qkv_attention.launches = 0

# gswm/ops/attention.py:443: fewer keys than this (cross-attention's 77) take
# the einsum path; the blockwise kernel starts here.
SPLIT_MIN_KEYS = 512
SPLIT_MAX_HEAD_DIM = 512


def flash_attention_split_reference(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor) -> torch.Tensor:
    """Plain version: (B, Sq, H, D) q, (B, Sk, H, D) k/v -> (B, Sq, H, D);
    matmul, exact softmax and matmul in fp32, cast back to q's dtype."""
    d = q.shape[-1]
    qf, kf, vf = (t.to(torch.float32).transpose(1, 2) for t in (q, k, v))
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * (d**-0.5)
    out = torch.matmul(torch.softmax(logits, dim=-1), vf)
    return out.transpose(1, 2).contiguous().to(q.dtype)


def flash_attention_split(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """(B, Sq, H, D) q, (B, Sk, H, D) k/v -> (B, Sq, H, D) attention output.

    The counterpart of ``gswm.ops.attention.flash_attention`` (this module's
    ``flash_attention`` is the natural-layout wrapper).  Below
    ``SPLIT_MIN_KEYS`` keys: the reference's einsum path (matmul in the input dtype, softmax in
    fp32, probabilities cast back).  Otherwise CPU: the plain version; CUDA:
    the kernel of csrc/flash_split.cu (bf16, D a multiple of 64 up to 512,
    any Sq and Sk)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"flash_attention_split: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         "(B, Sq, H, D) and (B, Sk, H, D)")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if sk < SPLIT_MIN_KEYS:
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (d**-0.5)
        probs = torch.softmax(logits.to(torch.float32), dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)
    if q.device.type == "cpu":
        return flash_attention_split_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_split: unsupported device {q.device}")
    _check_cuda_bf16("flash_attention_split", q, k, v)
    if d % 64 or d > SPLIT_MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_split: head dim {d} is not a multiple "
                         f"of 64 up to {SPLIT_MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    lib = native.library()
    with torch.cuda.device(q.device):
        lib.call("gswm_flash_split", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), b, sq, sk, h, d, native.stream_handle(q.device))
    flash_attention_split.launches += 1
    return out


flash_attention_split.launches = 0
