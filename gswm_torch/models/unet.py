"""UNet2DCondition — the denoiser (PyTorch, NCHW).  Port of
``gswm.models.unet``, SDXL's addition embeddings included.

Public convention as in the JAX package: latents NCHW (B, 4, H/8, W/8) in,
float32 NCHW out; the compute dtype is the dtype of the module's weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gswm_torch.models.configs import UNetConfig
from gswm_torch.models.layers import (
    Downsample,
    GroupNorm32,
    ResnetBlock,
    TimeEmbedding,
    Transformer2D,
    Upsample,
    timestep_embedding,
)


class _Block(nn.Module):
    """Resnets, optional cross-attention transformers and an optional
    down- or upsampler: diffusers' CrossAttnDown/UpBlock2D layout."""

    def __init__(self, in_channels: list[int], out_channels: int, cfg: UNetConfig,
                 level: int, temb_dim: int, n_attn: int,
                 downsample: bool = False, upsample: bool = False):
        super().__init__()
        heads = cfg.heads_for(out_channels)
        self.resnets = nn.ModuleList(
            ResnetBlock(c, out_channels, cfg.norm_groups, temb_dim)
            for c in in_channels)
        self.attentions = nn.ModuleList(
            Transformer2D(out_channels, heads, out_channels // heads,
                          cfg.cross_attn_dim, cfg.depth_for(level),
                          cfg.use_linear_projection, cfg.norm_groups)
            for _ in range(n_attn))
        self.downsamplers = nn.ModuleList(
            [Downsample(out_channels, out_channels)] if downsample else [])
        self.upsamplers = nn.ModuleList(
            [Upsample(out_channels)] if upsample else [])


class UNet2DCondition(nn.Module):
    def __init__(self, config: UNetConfig):
        super().__init__()
        cfg = self.config = config
        boc = cfg.block_out_channels
        n = len(boc)
        temb_dim = boc[0] * 4
        self.time_embedding = TimeEmbedding(boc[0], temb_dim)
        # SDXL: (pooled text ++ 6 time_ids x 256 features) -> temb_dim
        self.add_embedding = (TimeEmbedding(cfg.addition_embed_dim, temb_dim)
                              if cfg.addition_embed_dim else None)
        self.conv_in = nn.Conv2d(cfg.sample_channels, boc[0], 3, padding=1)

        skip_channels = [boc[0]]
        x_ch = boc[0]
        self.down_blocks = nn.ModuleList()
        for lvl, ch in enumerate(boc):
            ins = [x_ch] + [ch] * (cfg.layers_per_block - 1)
            self.down_blocks.append(_Block(
                ins, ch, cfg, lvl, temb_dim,
                len(ins) if cfg.cross_attn_levels[lvl] else 0,
                downsample=lvl < n - 1))
            skip_channels += [ch] * (cfg.layers_per_block + (lvl < n - 1))
            x_ch = ch

        mid = boc[-1]
        self.mid_block = _Block([mid, mid], mid, cfg, n - 1, temb_dim, 1)

        self.up_blocks = nn.ModuleList()
        for lvl in reversed(range(n)):
            ch = boc[lvl]
            ins = []
            for _ in range(cfg.layers_per_block + 1):
                ins.append(x_ch + skip_channels.pop())
                x_ch = ch
            self.up_blocks.append(_Block(
                ins, ch, cfg, lvl, temb_dim,
                len(ins) if cfg.cross_attn_levels[lvl] else 0,
                upsample=lvl > 0))

        self.conv_norm_out = GroupNorm32(cfg.norm_groups, boc[0], eps=1e-5)
        self.conv_out = nn.Conv2d(boc[0], cfg.sample_channels, 3, padding=1)

    def forward(self, latents: torch.Tensor, timesteps, context: torch.Tensor,
                added_cond: dict | None = None):
        """latents (B, C, h, w); timesteps (B,) or scalar; context
        (B, seq, cross_attn_dim); added_cond (SDXL): ``text_embeds``
        (B, pooled) and ``time_ids`` (B, 6).  Returns float32 (B, C, h, w)."""
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        x = latents.to(dtype)
        context = context.to(dtype)
        t = torch.as_tensor(timesteps, device=x.device)
        if t.dim() == 0:
            t = t.expand(x.shape[0])
        temb = timestep_embedding(t, cfg.block_out_channels[0], cfg.flip_sin_to_cos,
                                  cfg.freq_shift).to(dtype)
        temb = self.time_embedding(temb)
        if self.add_embedding is not None:
            temb = temb + self.add_embedding(self._added_features(added_cond, x.shape[0],
                                                                  dtype))

        x = self.conv_in(x)
        skips = [x]
        for block in self.down_blocks:
            for i, resnet in enumerate(block.resnets):
                x = resnet(x, temb)
                if len(block.attentions):
                    x = block.attentions[i](x, context)
                skips.append(x)
            for down in block.downsamplers:
                x = down(x)
                skips.append(x)

        mid = self.mid_block
        x = mid.resnets[0](x, temb)
        x = mid.attentions[0](x, context)
        x = mid.resnets[1](x, temb)

        for block in self.up_blocks:
            for i, resnet in enumerate(block.resnets):
                x = resnet(torch.cat([x, skips.pop()], dim=1), temb)
                if len(block.attentions):
                    x = block.attentions[i](x, context)
            for up in block.upsamplers:
                x = up(x)

        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        return x.to(torch.float32)

    def _added_features(self, added_cond, batch: int, dtype) -> torch.Tensor:
        """SDXL micro-conditioning (gswm/models/unet.py:140-156): 256
        sinusoidal features of each time_id in fp32, after the pooled text
        embeds, cast to the compute dtype."""
        if added_cond is None:
            raise ValueError("SDXL config needs added_cond {text_embeds, time_ids}")
        cfg = self.config
        tid = torch.as_tensor(added_cond["time_ids"], device=self.conv_in.weight.device)
        feats = timestep_embedding(tid.reshape(-1), 256, cfg.flip_sin_to_cos,
                                   cfg.freq_shift).reshape(batch, -1)
        text = torch.as_tensor(added_cond["text_embeds"], device=feats.device)
        return torch.cat([text.to(torch.float32), feats], dim=-1).to(dtype)
