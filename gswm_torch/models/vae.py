"""AutoencoderKL — VAE encoder and decoder (PyTorch, NCHW); port of
``gswm.models.vae``.

The extraction path needs only the encoder's *posterior mean*: the reference
uses ``posterior.mean * 0.18215``, never a sample (extract.py:39-43).
``encode_moments`` returns (mean, logvar); ``encode`` the scaled mean;
``decode`` maps scaled latents back to images in [-1, 1].

``GSWM_VAE_REMAT=block`` (read at each call, as the JAX package's switch
is read at trace time) checkpoints each encoder and decoder block under
autograd: the backward stores block-boundary activations and recomputes one
block's internals at a time (gswm/models/vae.py:81-92).  Parameter names do
not change; without a gradient, or with the switch unset, nothing does.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from gswm_torch.models.configs import VAEConfig
from gswm_torch.models.layers import (
    Downsample,
    GroupNorm32,
    ResnetBlock,
    Upsample,
    VAEAttention,
)
from gswm_torch.utils.profiling import span


def _block(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``block(x)``, checkpointed under ``GSWM_VAE_REMAT=block`` when autograd
    records."""
    if os.environ.get("GSWM_VAE_REMAT") == "block" and torch.is_grad_enabled():
        return checkpoint(block, x, use_reentrant=False)
    return block(x)


class EncoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, layers: int,
                 norm_groups: int, add_downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(in_channels if i == 0 else out_channels, out_channels,
                        norm_groups, norm_eps=1e-6)
            for i in range(layers))
        # diffusers VAE encoder: asymmetric (0,1,0,1) pad + VALID conv
        self.downsamplers = nn.ModuleList(
            [Downsample(out_channels, out_channels, asymmetric_pad=True)]
            if add_downsample else [])

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        for down in self.downsamplers:
            x = down(x)
        return x


class DecoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, layers: int,
                 norm_groups: int, add_upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(in_channels if i == 0 else out_channels, out_channels,
                        norm_groups, norm_eps=1e-6)
            for i in range(layers))
        self.upsamplers = nn.ModuleList(
            [Upsample(out_channels)] if add_upsample else [])

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        for up in self.upsamplers:
            x = up(x)
        return x


class VAEMid(nn.Module):
    def __init__(self, channels: int, norm_groups: int):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(channels, channels, norm_groups, norm_eps=1e-6)
            for _ in range(2))
        self.attentions = nn.ModuleList([VAEAttention(channels, norm_groups)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        boc = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, boc[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            EncoderBlock(boc[max(i - 1, 0)], ch, cfg.layers_per_block,
                         cfg.norm_groups, add_downsample=i < len(boc) - 1)
            for i, ch in enumerate(boc))
        self.mid_block = VAEMid(boc[-1], cfg.norm_groups)
        self.conv_norm_out = GroupNorm32(cfg.norm_groups, boc[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(boc[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = _block(block, x)
        x = _block(self.mid_block, x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev = tuple(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = VAEMid(rev[0], cfg.norm_groups)
        self.up_blocks = nn.ModuleList(
            DecoderBlock(rev[max(i - 1, 0)], ch, cfg.layers_per_block + 1,
                         cfg.norm_groups, add_upsample=i < len(rev) - 1)
            for i, ch in enumerate(rev))
        self.conv_norm_out = GroupNorm32(cfg.norm_groups, rev[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg.in_channels, 3, padding=1)

    def forward(self, z):
        x = _block(self.mid_block, self.conv_in(z))
        for block in self.up_blocks:
            x = _block(block, x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    """SD's KL autoencoder: encoder + ``quant_conv``, ``post_quant_conv`` +
    decoder."""

    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels,
                                    2 * config.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(config.latent_channels,
                                         config.latent_channels, 1)

    def encode_moments(self, images: torch.Tensor):
        """images (B, 3, H, W) in [-1, 1] -> (mean, logvar), each float32
        (B, latent_channels, H/8, W/8)."""
        x = images.to(self.quant_conv.weight.dtype)
        h = self.quant_conv(self.encoder(x)).to(torch.float32)
        mean, logvar = h.chunk(2, dim=1)
        return mean, logvar

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """Posterior MEAN scaled by the SD factor (extract.py:42 parity)."""
        with span("gswm.vae.encode"):
            mean, _ = self.encode_moments(images)
            return mean * self.config.scaling_factor

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Scaled latents (B, latent_channels, h, w) -> float32 images
        (B, 3, f*h, f*w), f = 2 ** (levels - 1), in [-1, 1]
        (gswm/models/vae.py:169-175)."""
        with span("gswm.vae.decode"):
            z = (latents / self.config.scaling_factor).to(self.quant_conv.weight.dtype)
            return self.decoder(self.post_quant_conv(z)).to(torch.float32)
