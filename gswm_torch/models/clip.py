"""CLIP (image and text towers) for the quality score, in plain PyTorch.

The JAX package scores images with transformers' ``FlaxCLIPModel``
(gswm/eval/quality.py:15-21), plain XLA; the port has its own module, plain
PyTorch likewise, because transformers is not a dependency of the port.
The parameter names are transformers' ``CLIPModel`` state dict's
(``vision_model.encoder.layers.0.self_attn.q_proj.weight``, ...):

  * the vision tower: a stride-p patch convolution without bias, a class
    embedding and position embeddings, ``pre_layrnorm``, the encoder layers
    of ``models.text`` without the causal mask, ``post_layernorm`` on the
    class token, then ``visual_projection``;
  * the text tower: ``models.text.TextEncoder`` (``ClipModel`` is one), its
    pooled output (at the first EOS, or at the largest id under the legacy
    ``eos_token_id`` 2) through ``text_projection``.

Configurations come as transformers' ``config.json`` dicts
(``config_from_dict``); keys a file leaves out take transformers' defaults.
Computes in float32 unless the caller casts it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gswm_torch.models.configs import TextConfig
from gswm_torch.models.text import CLIPEncoder, TextEncoder

# transformers' CLIPTextConfig / CLIPVisionConfig / CLIPConfig defaults, for
# the keys a config.json leaves out
_TEXT_DEFAULTS = dict(vocab_size=49408, hidden_size=512, intermediate_size=2048,
                      num_hidden_layers=12, num_attention_heads=8,
                      max_position_embeddings=77, hidden_act="quick_gelu",
                      layer_norm_eps=1e-5, eos_token_id=49407)
_VISION_DEFAULTS = dict(hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
                        num_attention_heads=12, num_channels=3, image_size=224,
                        patch_size=32, hidden_act="quick_gelu", layer_norm_eps=1e-5)
_PROJECTION_DIM = 512
# transformers' logit_scale_init_value: log(1 / 0.07)
LOGIT_SCALE_INIT = 2.6592


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    patch_size: int = 32
    image_size: int = 224
    num_channels: int = 3
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    intermediate_size: Optional[int] = 3072


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    text: TextConfig
    vision: VisionConfig
    projection_dim: int = _PROJECTION_DIM


def config_from_dict(config: dict) -> ClipConfig:
    """A transformers ``CLIPConfig`` as its ``config.json`` holds it ->
    ``ClipConfig``."""
    t = {**_TEXT_DEFAULTS, **(config.get("text_config") or {})}
    v = {**_VISION_DEFAULTS, **(config.get("vision_config") or {})}
    text = TextConfig(vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
                      num_layers=t["num_hidden_layers"], num_heads=t["num_attention_heads"],
                      max_length=t["max_position_embeddings"], hidden_act=t["hidden_act"],
                      layer_norm_eps=t["layer_norm_eps"],
                      intermediate_size=t["intermediate_size"],
                      eos_token_id=t["eos_token_id"])
    vision = VisionConfig(hidden_size=v["hidden_size"], num_layers=v["num_hidden_layers"],
                          num_heads=v["num_attention_heads"], patch_size=v["patch_size"],
                          image_size=v["image_size"], num_channels=v["num_channels"],
                          hidden_act=v["hidden_act"], layer_norm_eps=v["layer_norm_eps"],
                          intermediate_size=v["intermediate_size"])
    return ClipConfig(text=text, vision=vision,
                      projection_dim=config.get("projection_dim", _PROJECTION_DIM))


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.empty(cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(cfg.num_channels, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        patches = (cfg.image_size // cfg.patch_size) ** 2
        self.position_embedding = nn.Embedding(patches + 1, cfg.hidden_size)

    def forward(self, pixel_values):
        x = self.patch_embedding(pixel_values).flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embedding.weight[None]


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = CLIPEncoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, pixel_values):
        """(B, C, image_size, image_size) -> (B, hidden) pooled class token."""
        x = self.pre_layrnorm(self.embeddings(pixel_values))
        for layer in self.encoder.layers:
            x = layer(x)
        return self.post_layernorm(x[:, 0])


class ClipModel(TextEncoder):
    """Both towers and their projections; a ``TextEncoder`` over the text
    tower, whose ``pooled`` gives the text embeddings."""

    def __init__(self, cfg: ClipConfig):
        super().__init__(cfg.text)
        self.clip_cfg = cfg
        self.vision_model = CLIPVisionTransformer(cfg.vision)
        self.visual_projection = nn.Linear(cfg.vision.hidden_size, cfg.projection_dim,
                                           bias=False)
        self.text_projection = nn.Linear(cfg.text.hidden_size, cfg.projection_dim,
                                         bias=False)
        self.logit_scale = nn.Parameter(torch.tensor(LOGIT_SCALE_INIT))

    def image_embeds(self, pixel_values) -> torch.Tensor:
        """(B, C, H, W) normalized pixels -> (B, projection_dim)."""
        return self.visual_projection(self.vision_model(pixel_values))

    def text_embeds(self, input_ids) -> torch.Tensor:
        """(B, L) token ids -> (B, projection_dim)."""
        return self.pooled(input_ids, self.text_projection.weight.t())

    def forward(self, pixel_values, input_ids) -> tuple[torch.Tensor, torch.Tensor]:
        """(image_embeds, text_embeds), each of unit length, as
        ``FlaxCLIPModel`` returns them."""
        return (F.normalize(self.image_embeds(pixel_values), dim=-1),
                F.normalize(self.text_embeds(input_ids), dim=-1))


def build_clip(config: dict | ClipConfig, generator: Optional[torch.Generator] = None,
               device="cuda") -> ClipModel:
    """A float32 ``ClipModel`` on ``device``: random weights from
    ``generator`` (default: seed 0 on ``device``; ``init_random_``'s rule,
    ``logit_scale`` at transformers' initial value)."""
    from gswm_torch.models.layers import init_random_

    cfg = config if isinstance(config, ClipConfig) else config_from_dict(config)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    with torch.device("meta"):
        model = ClipModel(cfg)
    model.to_empty(device=device)
    init_random_(model, generator)
    with torch.no_grad():
        model.logit_scale.fill_(LOGIT_SCALE_INIT)
    return model.eval().requires_grad_(False)
