"""Model architecture presets.

Shapes follow the published Stable Diffusion configs the reference targets
(README.md:17: v1-4, v2-0, v2-1; extract.py:183 default v2-1-base).  TINY is a
structurally identical miniature for closed-loop tests and CI (SURVEY.md §4
"tiny-UNet DDIM round trip").
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    sample_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # which down/up levels carry cross-attention transformers (SD: all but last)
    cross_attn_levels: Tuple[bool, ...] = (True, True, True, False)
    # int = same depth everywhere; tuple = per-level (SDXL: (1, 2, 10))
    transformer_depth: int | Tuple[int, ...] = 1
    # SDXL addition embeddings: concat(text_embeds[1280], 6 time_ids x 256)
    # -> Dense(time_embed_dim), added to the timestep embedding.
    addition_embed_dim: int = 0  # 0 = disabled (SD1/2)
    # attention head policy: SD1.x fixes 8 heads; SD2.x fixes head_dim=64.
    num_heads: int | None = 8
    head_dim: int | None = None
    cross_attn_dim: int = 768
    use_linear_projection: bool = False  # True for SD2.x transformers
    freq_shift: int = 0
    flip_sin_to_cos: bool = True
    norm_groups: int = 32

    def heads_for(self, channels: int) -> int:
        if self.head_dim is not None:
            return channels // self.head_dim
        return self.num_heads

    def depth_for(self, level: int) -> int:
        if isinstance(self.transformer_depth, tuple):
            return self.transformer_depth[level]
        return self.transformer_depth


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    scaling_factor: float = 0.18215  # extract.py:42


@dataclasses.dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    hidden_act: str = "quick_gelu"
    # SD2.x reads the penultimate layer ("clip skip" fixed at final for 1.x)
    penultimate: bool = False
    layer_norm_eps: float = 1e-5
    # the MLP's width (None: 4 x hidden_size)
    intermediate_size: Optional[int] = None
    # the token ``pooled`` reads: None = CLIP's <|endoftext|> (49407, the
    # last id of a smaller vocabulary), transformers' legacy 2 = the largest
    # id of each row, else the first position holding this id
    eos_token_id: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ModelPreset:
    name: str
    unet: UNetConfig
    vae: VAEConfig
    text: TextConfig
    # SDXL second (OpenCLIP-bigG) encoder; contexts are concatenated and its
    # pooled output feeds the addition embeddings.
    text2: "TextConfig | None" = None
    prediction_type: str = "epsilon"
    default_resolution: int = 512


SD_1_4 = ModelPreset(
    name="sd-1-4",
    unet=UNetConfig(cross_attn_dim=768, num_heads=8, head_dim=None,
                    use_linear_projection=False),
    vae=VAEConfig(),
    text=TextConfig(hidden_size=768, num_layers=12, num_heads=12,
                    hidden_act="quick_gelu"),
    prediction_type="epsilon",
    default_resolution=512,
)

SD_2_1_BASE = ModelPreset(
    name="sd-2-1-base",
    unet=UNetConfig(cross_attn_dim=1024, num_heads=None, head_dim=64,
                    use_linear_projection=True),
    vae=VAEConfig(),
    # The published stabilityai/stable-diffusion-2-1* text encoders ship
    # pre-truncated to 23 layers (the penultimate layer is baked in);
    # diffusers then uses last_hidden_state.  penultimate=True here would
    # clip-skip twice.  Runtime clip-skip stays True only for SDXL, whose
    # encoders ship full-depth.
    text=TextConfig(hidden_size=1024, num_layers=23, num_heads=16,
                    hidden_act="gelu", penultimate=False),
    prediction_type="epsilon",
    default_resolution=512,
)

SD_2_1_768 = ModelPreset(
    name="sd-2-1",
    unet=SD_2_1_BASE.unet,
    vae=VAEConfig(),
    text=SD_2_1_BASE.text,
    prediction_type="v_prediction",
    default_resolution=768,
)

# SD v2-0 (README.md:17 claims v1-4/v2-0/v2-1 coverage): identical
# architecture family to 2.1-base — same UNet/VAE/OpenCLIP-H-23 text encoder,
# epsilon prediction at 512.  Only the weights differ.
SD_2_0_BASE = ModelPreset(
    name="sd-2-0-base",
    unet=SD_2_1_BASE.unet,
    vae=VAEConfig(),
    text=SD_2_1_BASE.text,
    prediction_type="epsilon",
    default_resolution=512,
)

SD_2_0_768 = ModelPreset(
    name="sd-2-0",
    unet=SD_2_1_BASE.unet,
    vae=VAEConfig(),
    text=SD_2_1_BASE.text,
    prediction_type="v_prediction",
    default_resolution=768,
)

SDXL_BASE = ModelPreset(
    name="sdxl-base",
    unet=UNetConfig(
        block_out_channels=(320, 640, 1280),
        layers_per_block=2,
        cross_attn_levels=(False, True, True),
        transformer_depth=(1, 2, 10),
        num_heads=None,
        head_dim=64,
        cross_attn_dim=2048,  # CLIP-L(768) ++ OpenCLIP-bigG(1280)
        use_linear_projection=True,
        addition_embed_dim=2816,  # text_embeds(1280) + 6 time_ids x 256
    ),
    vae=VAEConfig(scaling_factor=0.13025),
    text=TextConfig(hidden_size=768, num_layers=12, num_heads=12,
                    hidden_act="quick_gelu", penultimate=True),
    text2=TextConfig(hidden_size=1280, num_layers=32, num_heads=20,
                     hidden_act="gelu", penultimate=True),
    prediction_type="epsilon",
    default_resolution=1024,
)

TINY_XL = ModelPreset(
    name="tiny-xl",
    unet=UNetConfig(
        block_out_channels=(32, 64),
        layers_per_block=1,
        cross_attn_levels=(False, True),
        transformer_depth=(1, 2),
        num_heads=2,
        cross_attn_dim=48,
        use_linear_projection=True,
        addition_embed_dim=32 + 6 * 256,
        norm_groups=8,
    ),
    vae=VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                  norm_groups=8, scaling_factor=0.13025),
    text=TextConfig(vocab_size=1000, hidden_size=16, num_layers=2,
                    num_heads=2, penultimate=True),
    text2=TextConfig(vocab_size=1000, hidden_size=32, num_layers=2,
                     num_heads=2, penultimate=True),
    prediction_type="epsilon",
    default_resolution=64,
)

TINY = ModelPreset(
    name="tiny",
    unet=UNetConfig(
        block_out_channels=(32, 64),
        layers_per_block=1,
        cross_attn_levels=(True, False),
        num_heads=2,
        cross_attn_dim=32,
        norm_groups=8,
    ),
    vae=VAEConfig(block_out_channels=(16, 32), layers_per_block=1, norm_groups=8),
    text=TextConfig(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2),
    prediction_type="epsilon",
    default_resolution=64,
)

PRESETS = {p.name: p for p in (SD_1_4, SD_2_0_BASE, SD_2_0_768, SD_2_1_BASE,
                               SD_2_1_768, SDXL_BASE, TINY, TINY_XL)}
