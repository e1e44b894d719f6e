"""CLIP text encoder (prompt conditioning) in PyTorch.

The JAX package wraps transformers' FlaxCLIPTextModel; the port has its own
module because transformers is not a dependency of the port.  Same
architecture and the same parameter names as transformers' CLIPTextModel
state dict (``text_model.encoder.layers.0.self_attn.q_proj.weight``):
token + position embeddings, pre-LN blocks with causal self-attention,
``gelu`` (exact erf) or ``quick_gelu`` MLPs, final LayerNorm.  The inversion
path only needs the empty prompt, whose ids are synthesized without a
tokenizer.  Runs in float32, as the JAX package's encoder does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gswm_torch.models.configs import TextConfig

BOS_ID = 49406
EOS_ID = 49407


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


_ACTIVATIONS = {"gelu": F.gelu, "quick_gelu": _quick_gelu}


class CLIPAttention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(hidden, hidden)
        self.k_proj = nn.Linear(hidden, hidden)
        self.v_proj = nn.Linear(hidden, hidden)
        self.out_proj = nn.Linear(hidden, hidden)

    def forward(self, x, bias):
        b, s, c = x.shape
        d = c // self.heads

        def split(t):
            return t.reshape(b, s, self.heads, d).transpose(1, 2)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        logits = torch.matmul(q * d**-0.5, k.transpose(-1, -2)) + bias
        out = torch.matmul(torch.softmax(logits, dim=-1), v)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, c))


class CLIPMLP(nn.Module):
    def __init__(self, hidden: int, act: str):
        super().__init__()
        self.act = _ACTIVATIONS[act]
        self.fc1 = nn.Linear(hidden, hidden * 4)
        self.fc2 = nn.Linear(hidden * 4, hidden)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg.hidden_size, cfg.num_heads)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.mlp = CLIPMLP(cfg.hidden_size, cfg.hidden_act)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)

    def forward(self, x, bias):
        x = x + self.self_attn(self.layer_norm1(x), bias)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_length, cfg.hidden_size)

    def forward(self, ids):
        pos = torch.arange(ids.shape[1], device=ids.device)
        return self.token_embedding(ids) + self.position_embedding(pos)[None]


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg)
                                    for _ in range(cfg.num_layers))


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)


class TextEncoder(nn.Module):
    """(B, L) token ids -> (B, L, hidden) context."""

    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = CLIPTextTransformer(cfg)

    def _hidden(self, input_ids, last: bool) -> tuple[torch.Tensor, torch.Tensor]:
        """(ids on the encoder's device, final_layer_norm of the last hidden
        state, or of the penultimate one unless ``last``)."""
        tm = self.text_model
        ids = torch.as_tensor(input_ids, dtype=torch.long,
                              device=tm.final_layer_norm.weight.device)
        x = tm.embeddings(ids)
        s = ids.shape[1]
        bias = torch.full((s, s), float("-inf"), device=x.device,
                          dtype=x.dtype).triu(1)  # causal
        layers = tm.encoder.layers
        for layer in (layers if last else layers[:-1]):
            x = layer(x, bias)
        return ids, tm.final_layer_norm(x)

    def forward(self, input_ids) -> torch.Tensor:
        # SD2.x-style clip skip: the penultimate hidden state, then the
        # final layer norm (diffusers semantics)
        return self._hidden(input_ids, last=not self.cfg.penultimate)[1]

    def pooled(self, input_ids, projection=None) -> torch.Tensor:
        """(B, L) ids -> (B, hidden) pooled embedding (gswm/models/text.py:
        71-85, transformers' CLIP pooling): the LAST layer's hidden state
        after the final layer norm, even with ``penultimate``, at the first
        EOS position (position 0 where there is none), then ``@ projection``
        ((hidden, out), SDXL's text_projection) when one is given."""
        ids, x = self._hidden(input_ids, last=True)
        eos = min(EOS_ID, self.cfg.vocab_size - 1)
        pos = (ids == eos).int().argmax(dim=-1)
        out = x[torch.arange(x.shape[0], device=x.device), pos]
        if projection is not None:
            out = out @ torch.as_tensor(projection, dtype=out.dtype, device=out.device)
        return out

    def empty_prompt_ids(self, batch: int = 1) -> np.ndarray:
        """Token ids for "" — BOS then EOS-padding (CLIP pads with EOS)."""
        bos = min(BOS_ID, self.cfg.vocab_size - 2)
        eos = min(EOS_ID, self.cfg.vocab_size - 1)
        ids = np.full((batch, self.cfg.max_length), eos, dtype=np.int64)
        ids[:, 0] = bos
        return ids
