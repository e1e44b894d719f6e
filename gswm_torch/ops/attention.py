"""Self-attention kernels of the PyTorch port, with their plain versions.

Two kernels, hand-written CUDA for Hopper (``gswm_torch/csrc``):

  * ``flash_attention`` (csrc/flash_attn.cu) — natural-layout flash
    attention on (B, S, H*64) bf16 q/k/v.  Serves the UNet's self-attention
    above the fused-qkv window (level 0's 4096 tokens at 512x512), where the
    TPU path runs ``gswm.ops.attention.xla_flash_attention`` (or the Pallas
    ``flash_attention_cres`` it displaced).
  * ``fused_qkv_attention`` (csrc/fused_qkv.cu + the flash core) — the
    bias-free q/k/v projections in a hand-written GEMM, then attention.
    Port of the Pallas ``flash_attention_fused_qkv``; serves 256..2304
    tokens (levels 1 and 2 at 512x512).

Both compute exact softmax (the TPU kernels' ``use_max`` recurrence).  The
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
    cast back to q's dtype (``gswm.ops.attention.reference_attention``)."""
    b, s, inner = q.shape
    d = inner // heads

    def split(t):  # (B, S, H*D) -> (B, H, S, D)
        return t.to(torch.float32).reshape(b, t.shape[1], heads, d).transpose(1, 2)

    logits = torch.matmul(split(q), split(k).transpose(-1, -2)) * (d**-0.5)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs, split(v))
    return out.transpose(1, 2).reshape(b, s, inner).to(q.dtype)


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
    csrc/flash_attn.cu (bf16, head dim 64, any S)."""
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
        lib.call("gswm_flash_attn", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), b, s, heads, native.stream_handle(q.device))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def fused_qkv_attention(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                        wv: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, C) x and bias-free (H*64, C) q/k/v weights -> (B, S, H*64).

    CPU: ``fused_qkv_attention_reference``.  CUDA: the projection GEMM of
    csrc/fused_qkv.cu, then the flash core (bf16, C % 64 == 0)."""
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
