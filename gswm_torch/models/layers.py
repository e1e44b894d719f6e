"""Shared building blocks for the UNet and VAE (PyTorch, NCHW).

Port of ``gswm.models.layers``.  Numerics kept from the JAX package:
  * GroupNorm statistics in fp32 whatever the compute dtype, then a cast back.
  * GEGLU: exact-erf gelu in fp32, tanh gelu in lower precision.
  * VAE-encoder Downsample pads (0,1,0,1) then runs a VALID stride-2 conv;
    the UNet's pads 1 on every side.
  * Attention tokens are (h, w) row-major, as in the JAX package's NHWC
    reshape: NCHW is permuted to NHWC before flattening.
Self-attention routes as the JAX package's does, by sequence length and the
same ``GSWM_*`` switches (``ops.attention.route_self_attention``): by
default the fused-qkv kernel at 256..2304 tokens, the natural-layout flash
kernel from 2305 up, plain matmul + fp32 softmax below; under the switches
the packed, transposed or split kernels.  Cross-attention is plain.  The VAE
mid-block attention takes the split flash kernel above
``VAE_FLASH_MIN_TOKENS``.

Module and parameter names follow diffusers' state-dict layout
(``down_blocks.0.resnets.1.conv1.weight``, ``to_out.0``, ``ff.net.2``), so
``models.bridge`` maps the JAX package's flax trees by renaming only.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gswm_torch.ops.attention import (
    flash_attention,
    flash_attention_packed,
    flash_attention_split,
    flash_attention_transposed,
    fused_qkv_attention,
    route_self_attention,
)

# gswm/models/layers.py:667: the VAE mid attention keeps the plain path up to
# this many tokens (512x512 images) and takes the split flash kernel above
# (768x768: 9216 tokens, whose fp32 logits are 340 MB per image).
VAE_FLASH_MIN_TOKENS = 4096


class GroupNorm32(nn.GroupNorm):
    """GroupNorm computed in fp32, cast back to the input dtype.  Its scale
    and bias stay float32 under a lower compute dtype (``to_compute_dtype_``),
    as the JAX package's do (gswm/models/layers.py:75-100)."""

    def forward(self, x):
        y = F.group_norm(x.float(), self.num_groups, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm computed in fp32 with float32 scale and bias, cast back to
    the input dtype: what flax's ``nn.LayerNorm(dtype=bf16)`` does with its
    float32 parameters (gswm/models/layers.py:578-587)."""

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


def to_compute_dtype_(module: nn.Module, device, dtype: torch.dtype) -> nn.Module:
    """Move ``module`` to ``device`` and cast it to ``dtype`` (in place);
    the norms' scales and biases stay float32.  The JAX package keeps
    float32 parameters under a bf16 compute dtype, which rounds every matmul
    and convolution weight at its use but never a norm's parameters (they
    enter float32 arithmetic as they are)."""
    module.to(device)
    for m in module.modules():
        if isinstance(m, (GroupNorm32, LayerNorm32)):
            continue  # never rounded, not even on the way
        for p in m.parameters(recurse=False):
            p.data = p.data.to(dtype)
        for name, buf in m.named_buffers(recurse=False):
            if buf.is_floating_point():
                m._buffers[name] = buf.to(dtype)
    return module


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       freq_shift: float = 0.0) -> torch.Tensor:
    """Sinusoidal timestep features (diffusers get_timestep_embedding
    semantics), fp32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(10000.0)
        * torch.arange(half, dtype=torch.float32, device=t.device)
        / (half - freq_shift))
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


class TimeEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, emb):
        return self.linear_2(F.silu(self.linear_1(emb)))


class ResnetBlock(nn.Module):
    """GN -> SiLU -> conv (+ time embedding) -> GN -> SiLU -> conv, residual.
    ``norm_eps``: 1e-5 in UNet resnets, 1e-6 in the VAE (diffusers)."""

    def __init__(self, in_channels: int, out_channels: int, norm_groups: int = 32,
                 temb_dim: Optional[int] = None, norm_eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm32(norm_groups, in_channels, eps=norm_eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = (nn.Linear(temb_dim, out_channels)
                              if temb_dim is not None else None)
        self.norm2 = GroupNorm32(norm_groups, out_channels, eps=norm_eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x, temb: Optional[torch.Tensor] = None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None and self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """(B, Sq, H*D) q, (B, Sk, H*D) k/v -> (B, Sq, H*D): matmul in the compute
    dtype, softmax in fp32 (the JAX package's einsum path)."""
    b, sq, inner = q.shape
    d = inner // heads

    def split(t):
        return t.reshape(b, t.shape[1], heads, d).transpose(1, 2)

    logits = torch.matmul(split(q), split(k).transpose(-1, -2)) * (d**-0.5)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = torch.matmul(probs, split(v))
    return out.transpose(1, 2).reshape(b, sq, inner)


class Attention(nn.Module):
    """Multi-head attention (self when context is None, cross otherwise) with
    bias-free q/k/v projections."""

    def __init__(self, query_dim: int, context_dim: int, heads: int, head_dim: int):
        super().__init__()
        inner = heads * head_dim
        self.heads = heads
        self.head_dim = head_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, inner))  # diffusers' to_out.0

    def forward(self, x, context=None):
        if context is not None:
            return self.to_out(plain_attention(self.to_q(x), self.to_k(context),
                                               self.to_v(context), self.heads))
        route = route_self_attention(x.shape[1], self.head_dim)
        wq, wk, wv = self.to_q.weight, self.to_k.weight, self.to_v.weight
        if route == "packed":
            return self._packed(x, wq, wk, wv)
        if route == "transposed":
            return self._transposed(x, wq, wk, wv)
        if route == "fused_qkv":
            return self.to_out(fused_qkv_attention(x, wq, wk, wv, self.heads))
        q, k, v = F.linear(x, wq), F.linear(x, wk), F.linear(x, wv)
        if route in ("xf", "cres"):
            out = flash_attention(q, k, v, self.heads)
        elif route == "split":
            b, s, inner = q.shape
            out = flash_attention_split(
                *(t.view(b, s, self.heads, self.head_dim) for t in (q, k, v))
            ).reshape(b, s, inner)
        else:
            out = plain_attention(q, k, v, self.heads)
        return self.to_out(out)

    def _packed(self, x, wq, wk, wv):
        """gswm/models/layers.py:437-464: one matmul into the pair-packed
        (B, S, 3*P*128) layout (weight rows zero-padded to P*128 per
        projection for odd head counts), the packed kernel, then to_out with
        zero weight columns under the pad head."""
        pad = -(-self.heads // 2) * 128 - self.heads * self.head_dim
        wqkv = torch.cat([F.pad(w, (0, 0, 0, pad)) for w in (wq, wk, wv)])
        out = flash_attention_packed(F.linear(x, wqkv))
        wo, bo = self.to_out[0].weight, self.to_out[0].bias
        return F.linear(out, F.pad(wo, (0, pad)), bo)

    def _transposed(self, x, wq, wk, wv):
        """gswm/models/layers.py:465-482: one ('nc,bsc->nbs') matmul into
        (3*inner, B, S) — torch's (out, in) weights are the JAX package's
        transposed qkv weight as they are — the transposed kernel, then
        to_out contracting dim 0 of its (inner, B, S) output."""
        b, s, c = x.shape
        wqkv = torch.cat([wq, wk, wv])  # (3 * inner, C)
        qkv_t = torch.matmul(wqkv, x.reshape(b * s, c).t()).view(-1, b, s)
        out_t = flash_attention_transposed(qkv_t, self.heads)
        out = F.linear(out_t.view(out_t.shape[0], b * s).t(), self.to_out[0].weight,
                       self.to_out[0].bias)
        return out.view(b, s, -1)


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        # exact erf gelu in fp32 (diffusers parity); the tanh form in bf16,
        # whose ~1e-3 error is below bf16's own step
        # (gswm/models/layers.py:546-554)
        exact = x.dtype == torch.float32
        return h * F.gelu(gate, approximate="none" if exact else "tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        # indices 0 and 2 match diffusers' net.0.proj / net.2 (1 is dropout)
        self.net = nn.Sequential(GEGLU(dim, dim * 4), nn.Identity(),
                                 nn.Linear(dim * 4, dim))

    def forward(self, x):
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, head_dim: int):
        super().__init__()
        self.norm1 = LayerNorm32(dim, eps=1e-5)
        self.attn1 = Attention(dim, dim, heads, head_dim)
        self.norm2 = LayerNorm32(dim, eps=1e-5)
        self.attn2 = Attention(dim, context_dim, heads, head_dim)
        self.norm3 = LayerNorm32(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """Spatial transformer: norm -> proj_in -> blocks over (h*w) tokens ->
    proj_out, residual.  ``use_linear_projection`` matches SD2.x."""

    def __init__(self, channels: int, heads: int, head_dim: int, context_dim: int,
                 depth: int = 1, use_linear_projection: bool = False,
                 norm_groups: int = 32):
        super().__init__()
        self.use_linear_projection = use_linear_projection
        # diffusers Transformer2DModel hardcodes GroupNorm eps=1e-6
        self.norm = GroupNorm32(norm_groups, channels, eps=1e-6)
        if use_linear_projection:
            self.proj_in = nn.Linear(channels, channels)
            self.proj_out = nn.Linear(channels, channels)
        else:
            self.proj_in = nn.Conv2d(channels, channels, 1)
            self.proj_out = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(channels, context_dim, heads, head_dim)
            for _ in range(depth))

    def forward(self, x, context):
        b, c, h, w = x.shape
        residual = x
        x = self.norm(x)
        if not self.use_linear_projection:
            x = self.proj_in(x)
        x = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        if self.use_linear_projection:
            x = self.proj_in(x)
        for block in self.transformer_blocks:
            x = block(x, context)
        if self.use_linear_projection:
            x = self.proj_out(x)
        x = x.reshape(b, h, w, c).permute(0, 3, 1, 2)
        if not self.use_linear_projection:
            x = self.proj_out(x)
        return x + residual


class Downsample(nn.Module):
    """Stride-2 3x3 conv.  ``asymmetric_pad`` (the VAE encoder): pad (0,1,0,1)
    then VALID; otherwise (the UNet) symmetric padding 1."""

    def __init__(self, in_channels: int, out_channels: int,
                 asymmetric_pad: bool = False):
        super().__init__()
        self.asymmetric_pad = asymmetric_pad
        self.conv = nn.Conv2d(in_channels, out_channels, 3, stride=2,
                              padding=0 if asymmetric_pad else 1)

    def forward(self, x):
        if self.asymmetric_pad:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class VAEAttention(nn.Module):
    """Single-head spatial self-attention of the VAE mid block: plain
    matmul + fp32 softmax (the JAX package's einsum branch) up to
    ``VAE_FLASH_MIN_TOKENS`` tokens, the split flash kernel with one head of
    d = C above, as gswm/models/layers.py:692-725."""

    def __init__(self, channels: int, norm_groups: int = 32):
        super().__init__()
        # diffusers VAE mid-block attention group_norm eps=1e-6
        self.group_norm = GroupNorm32(norm_groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.Sequential(nn.Linear(channels, channels))

    def forward(self, x):
        b, c, h, w = x.shape
        residual = x
        x = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        if h * w > VAE_FLASH_MIN_TOKENS:
            out = flash_attention_split(q[:, :, None], k[:, :, None],
                                        v[:, :, None])[:, :, 0]
        else:
            out = plain_attention(q, k, v, 1)
        out = self.to_out(out)
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2) + residual


def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter from ``generator`` (in place): weights of rank >= 2
    (linear, conv, embedding) ~ N(0, 1/fan_in), as flax's lecun-normal
    default; norm scales 1; biases 0.  Parameters must lie on the
    generator's device."""
    for name, p in module.named_parameters():
        with torch.no_grad():
            if p.dim() >= 2:
                fan_in = math.prod(p.shape[1:])
                p.normal_(0.0, fan_in**-0.5, generator=generator)
            elif name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.zero_()
    return module
