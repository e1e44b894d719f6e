"""The plain reference of the Stable Diffusion family: UNet, VAE and CLIP
text encoder, in float32 PyTorch with no kernel.

A frozen copy of the measured port's plain model code (NCHW, diffusers'
and transformers' state-dict names and layouts), with every kernel call
replaced by plain attention and ``F.group_norm``: attention is a matmul, a
float32 softmax and a matmul; GroupNorm and LayerNorm compute in float32.
Departures from the published models: none in the mathematics; the
configuration's sizes come from ``h100bench/configs/<name>.json``.

Products go through ``self.prec`` (``precision.Precision``), float32 unless
the control asks for a lower precision. ``ATTENTION_LOG``, when a list, is
handed one ``(kind, batch, queries, keys, heads, head_dim)`` tuple for every
attention core computed: the benchmark counts attention work from it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from h100bench.reference.precision import FP32

ATTENTION_LOG = None


def _log_core(kind: str, q: torch.Tensor, k: torch.Tensor) -> None:
    if ATTENTION_LOG is not None:
        b, h, sq, d = q.shape
        ATTENTION_LOG.append((kind, b, sq, k.shape[2], h, d))


class Linear(nn.Linear):
    prec = FP32

    def forward(self, x):
        b = None if self.bias is None else self.bias.float()
        return F.linear(self.prec(x), self.prec(self.weight), b)


class Conv2d(nn.Conv2d):
    prec = FP32

    def forward(self, x):
        b = None if self.bias is None else self.bias.float()
        return F.conv2d(self.prec(x), self.prec(self.weight), b, self.stride,
                        self.padding)


class GroupNorm32(nn.GroupNorm):
    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps)


class LayerNorm32(nn.LayerNorm):
    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps)


def attention(q, k, v, heads: int, prec, kind: str, bias=None):
    """(B, Sq, H*D) q, (B, Sk, H*D) k and v -> (B, Sq, H*D): logits scaled by
    D^-0.5, softmax in float32, ``bias`` (Sq, Sk) added to the logits."""
    b, sq, inner = q.shape
    d = inner // heads

    def split(t):
        return t.reshape(b, t.shape[1], heads, d).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    _log_core(kind, q, k)
    logits = torch.matmul(prec(q), prec(k).transpose(-1, -2)) * (d ** -0.5)
    if bias is not None:
        logits = logits + bias
    out = torch.matmul(prec(torch.softmax(logits.float(), dim=-1)), prec(v))
    return out.transpose(1, 2).reshape(b, sq, inner)


def timestep_embedding(t, dim: int, flip_sin_to_cos: bool = True,
                       freq_shift: float = 0.0):
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / (half - freq_shift))
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)] if flip_sin_to_cos
                    else [torch.sin(args), torch.cos(args)], dim=-1)
    return F.pad(emb, (0, 1)) if dim % 2 else emb


class TimeEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = Linear(in_dim, dim)
        self.linear_2 = Linear(dim, dim)

    def forward(self, emb):
        return self.linear_2(F.silu(self.linear_1(emb)))


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int, temb_dim=None, eps=1e-5):
        super().__init__()
        self.norm1 = GroupNorm32(groups, cin, eps=eps)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = Linear(temb_dim, cout) if temb_dim is not None else None
        self.norm2 = GroupNorm32(groups, cout, eps=eps)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None and self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    prec = FP32

    def __init__(self, query_dim: int, context_dim: int, heads: int, head_dim: int):
        super().__init__()
        inner = heads * head_dim
        self.heads = heads
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(context_dim, inner, bias=False)
        self.to_v = Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, inner))

    def forward(self, x, context=None):
        kind = "self" if context is None else "cross"
        c = x if context is None else context
        out = attention(self.to_q(x), self.to_k(c), self.to_v(c), self.heads,
                        self.prec, kind)
        return self.to_out(out)


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * 4), nn.Identity(), Linear(dim * 4, dim))

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
    def __init__(self, channels, heads, head_dim, context_dim, depth, linear_proj, groups):
        super().__init__()
        self.linear_proj = linear_proj
        self.norm = GroupNorm32(groups, channels, eps=1e-6)
        proj = (lambda: Linear(channels, channels)) if linear_proj else \
            (lambda: Conv2d(channels, channels, 1))
        self.proj_in = proj()
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(channels, context_dim, heads, head_dim)
            for _ in range(depth))
        self.proj_out = proj()

    def forward(self, x, context):
        b, c, h, w = x.shape
        residual = x
        x = self.norm(x)
        if not self.linear_proj:
            x = self.proj_in(x)
        x = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        if self.linear_proj:
            x = self.proj_in(x)
        for block in self.transformer_blocks:
            x = block(x, context)
        if self.linear_proj:
            x = self.proj_out(x)
        x = x.reshape(b, h, w, c).permute(0, 3, 1, 2)
        if not self.linear_proj:
            x = self.proj_out(x)
        return x + residual


class Downsample(nn.Module):
    def __init__(self, channels: int, asymmetric_pad: bool = False):
        super().__init__()
        self.asymmetric_pad = asymmetric_pad
        self.conv = Conv2d(channels, channels, 3, stride=2,
                           padding=0 if asymmetric_pad else 1)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)) if self.asymmetric_pad else x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def _heads(cfg: dict, channels: int) -> int:
    return channels // cfg["head_dim"] if cfg.get("head_dim") else cfg["num_heads"]


def _depth(cfg: dict, level: int) -> int:
    d = cfg["transformer_depth"]
    return d[level] if isinstance(d, list) else d


class _Block(nn.Module):
    def __init__(self, ins, cout, cfg, level, temb_dim, n_attn, down=False, up=False):
        super().__init__()
        heads = _heads(cfg, cout)
        g = cfg["norm_groups"]
        self.resnets = nn.ModuleList(ResnetBlock(c, cout, g, temb_dim) for c in ins)
        self.attentions = nn.ModuleList(
            Transformer2D(cout, heads, cout // heads, cfg["cross_attn_dim"],
                          _depth(cfg, level), cfg["use_linear_projection"], g)
            for _ in range(n_attn))
        self.downsamplers = nn.ModuleList([Downsample(cout)] if down else [])
        self.upsamplers = nn.ModuleList([Upsample(cout)] if up else [])


class UNet(nn.Module):
    """diffusers' UNet2DConditionModel of SD 1.x, 2.x and SDXL."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        boc = cfg["block_out_channels"]
        n = len(boc)
        temb = boc[0] * 4
        self.time_embedding = TimeEmbedding(boc[0], temb)
        add = cfg.get("addition_embed_dim", 0)
        self.add_embedding = TimeEmbedding(add, temb) if add else None
        self.conv_in = Conv2d(cfg["sample_channels"], boc[0], 3, padding=1)
        lpb = cfg["layers_per_block"]
        attn = cfg["cross_attn_levels"]
        skips, x_ch = [boc[0]], boc[0]
        self.down_blocks = nn.ModuleList()
        for lvl, ch in enumerate(boc):
            ins = [x_ch] + [ch] * (lpb - 1)
            self.down_blocks.append(_Block(ins, ch, cfg, lvl, temb,
                                           len(ins) if attn[lvl] else 0, down=lvl < n - 1))
            skips += [ch] * (lpb + (lvl < n - 1))
            x_ch = ch
        self.mid_block = _Block([boc[-1]] * 2, boc[-1], cfg, n - 1, temb, 1)
        self.up_blocks = nn.ModuleList()
        for lvl in reversed(range(n)):
            ch, ins = boc[lvl], []
            for _ in range(lpb + 1):
                ins.append(x_ch + skips.pop())
                x_ch = ch
            self.up_blocks.append(_Block(ins, ch, cfg, lvl, temb,
                                         len(ins) if attn[lvl] else 0, up=lvl > 0))
        self.conv_norm_out = GroupNorm32(cfg["norm_groups"], boc[0], eps=1e-5)
        self.conv_out = Conv2d(boc[0], cfg["sample_channels"], 3, padding=1)

    def forward(self, x, t, context, added_cond=None):
        """float32 (B, C, h, w) latents, a scalar or (B,) timestep, (B, seq,
        cross_attn_dim) context; SDXL's ``added_cond`` of ``text_embeds`` and
        ``time_ids``. Returns float32 (B, C, h, w)."""
        cfg = self.cfg
        x = x.float()
        t = torch.as_tensor(t, device=x.device)
        if t.dim() == 0:
            t = t.expand(x.shape[0])
        temb = self.time_embedding(timestep_embedding(
            t, cfg["block_out_channels"][0], cfg["flip_sin_to_cos"], cfg["freq_shift"]))
        if self.add_embedding is not None:
            tid = added_cond["time_ids"].to(x.device)
            feats = timestep_embedding(tid.reshape(-1), 256, cfg["flip_sin_to_cos"],
                                       cfg["freq_shift"]).reshape(x.shape[0], -1)
            temb = temb + self.add_embedding(
                torch.cat([added_cond["text_embeds"].float(), feats], dim=-1))
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
        x = mid.resnets[1](mid.attentions[0](mid.resnets[0](x, temb), context), temb)
        for block in self.up_blocks:
            for i, resnet in enumerate(block.resnets):
                x = resnet(torch.cat([x, skips.pop()], dim=1), temb)
                if len(block.attentions):
                    x = block.attentions[i](x, context)
            for up in block.upsamplers:
                x = up(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VAEAttention(nn.Module):
    prec = FP32

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm32(groups, channels, eps=1e-6)
        self.to_q = Linear(channels, channels)
        self.to_k = Linear(channels, channels)
        self.to_v = Linear(channels, channels)
        self.to_out = nn.Sequential(Linear(channels, channels))

    def forward(self, x):
        b, c, h, w = x.shape
        res = x
        x = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        out = attention(self.to_q(x), self.to_k(x), self.to_v(x), 1, self.prec, "vae")
        return self.to_out(out).reshape(b, h, w, c).permute(0, 3, 1, 2) + res


class _VAEBlock(nn.Module):
    def __init__(self, cin, cout, layers, groups, down=False, up=False):
        super().__init__()
        self.resnets = nn.ModuleList(ResnetBlock(cin if i == 0 else cout, cout, groups,
                                                 eps=1e-6) for i in range(layers))
        if down:
            self.downsamplers = nn.ModuleList([Downsample(cout, asymmetric_pad=True)])
        if up:
            self.upsamplers = nn.ModuleList([Upsample(cout)])

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        for m in getattr(self, "downsamplers", []):
            x = m(x)
        for m in getattr(self, "upsamplers", []):
            x = m(x)
        return x


class VAEMid(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList(ResnetBlock(channels, channels, groups, eps=1e-6)
                                     for _ in range(2))
        self.attentions = nn.ModuleList([VAEAttention(channels, groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class Encoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        boc, g, lpb = cfg["block_out_channels"], cfg["norm_groups"], cfg["layers_per_block"]
        self.conv_in = Conv2d(cfg["in_channels"], boc[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            _VAEBlock(boc[max(i - 1, 0)], ch, lpb, g, down=i < len(boc) - 1)
            for i, ch in enumerate(boc))
        self.mid_block = VAEMid(boc[-1], g)
        self.conv_norm_out = GroupNorm32(g, boc[-1], eps=1e-6)
        self.conv_out = Conv2d(boc[-1], 2 * cfg["latent_channels"], 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        return self.conv_out(F.silu(self.conv_norm_out(self.mid_block(x))))


class Decoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        rev, g = list(reversed(cfg["block_out_channels"])), cfg["norm_groups"]
        self.conv_in = Conv2d(cfg["latent_channels"], rev[0], 3, padding=1)
        self.mid_block = VAEMid(rev[0], g)
        self.up_blocks = nn.ModuleList(
            _VAEBlock(rev[max(i - 1, 0)], ch, cfg["layers_per_block"] + 1, g,
                      up=i < len(rev) - 1)
            for i, ch in enumerate(rev))
        self.conv_norm_out = GroupNorm32(g, rev[-1], eps=1e-6)
        self.conv_out = Conv2d(rev[-1], cfg["in_channels"], 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VAE(nn.Module):
    """SD's KL autoencoder; the extraction path reads the posterior mean."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        lc = cfg["latent_channels"]
        self.quant_conv = Conv2d(2 * lc, 2 * lc, 1)
        self.post_quant_conv = Conv2d(lc, lc, 1)

    def encode(self, images):
        """Images in [0, 1] -> the posterior mean times the scaling factor."""
        h = self.quant_conv(self.encoder(2.0 * images.float() - 1.0))
        return h[:, : self.cfg["latent_channels"]] * self.cfg["scaling_factor"]

    def decode(self, latents):
        """Scaled latents -> images clamped to [0, 1]."""
        x = self.decoder(self.post_quant_conv(latents.float() / self.cfg["scaling_factor"]))
        return torch.clamp(x * 0.5 + 0.5, 0.0, 1.0)


_ACT = {"gelu": F.gelu, "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x)}


class CLIPAttention(nn.Module):
    prec = FP32

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = Linear(hidden, hidden)
        self.k_proj = Linear(hidden, hidden)
        self.v_proj = Linear(hidden, hidden)
        self.out_proj = Linear(hidden, hidden)

    def forward(self, x, bias):
        out = attention(self.q_proj(x), self.k_proj(x), self.v_proj(x), self.heads,
                        self.prec, "text", bias)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, hidden: int, act: str, inner: int):
        super().__init__()
        self.act = _ACT[act]
        self.fc1 = Linear(hidden, inner)
        self.fc2 = Linear(inner, hidden)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        h, eps = cfg["hidden_size"], cfg["layer_norm_eps"]
        self.self_attn = CLIPAttention(h, cfg["num_heads"])
        self.layer_norm1 = nn.LayerNorm(h, eps=eps)
        self.mlp = CLIPMLP(h, cfg["hidden_act"], cfg.get("intermediate_size") or 4 * h)
        self.layer_norm2 = nn.LayerNorm(h, eps=eps)

    def forward(self, x, bias):
        x = x + self.self_attn(self.layer_norm1(x), bias)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg["vocab_size"], cfg["hidden_size"])
        self.position_embedding = nn.Embedding(cfg["max_length"], cfg["hidden_size"])


class _Encoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg) for _ in range(cfg["num_layers"]))


class _TextTransformer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg["hidden_size"], eps=cfg["layer_norm_eps"])


BOS_ID, EOS_ID = 49406, 49407


class TextEncoder(nn.Module):
    """transformers' CLIPTextModel: causal pre-LN blocks and the final
    LayerNorm, read at the last layer or, with ``penultimate``, the one
    before it; ``pooled`` reads the last layer at the first EOS."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        self.text_model = _TextTransformer(cfg)

    def _hidden(self, ids, last: bool):
        tm = self.text_model
        ids = torch.as_tensor(ids, dtype=torch.long, device=tm.final_layer_norm.weight.device)
        s = ids.shape[1]
        pos = torch.arange(s, device=ids.device)
        x = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding(pos)[None]
        bias = torch.full((s, s), float("-inf"), device=x.device).triu(1)
        layers = tm.encoder.layers
        for layer in (layers if last else layers[:-1]):
            x = layer(x, bias)
        return ids, tm.final_layer_norm(x)

    def forward(self, ids):
        return self._hidden(ids, last=not self.cfg["penultimate"])[1]

    def pooled(self, ids, projection=None):
        ids, x = self._hidden(ids, last=True)
        eos = min(EOS_ID, self.cfg["vocab_size"] - 1)
        out = x[torch.arange(x.shape[0], device=x.device), (ids == eos).int().argmax(dim=-1)]
        return out if projection is None else out @ projection.float()

    def empty_prompt_ids(self, batch: int = 1):
        ids = torch.full((batch, self.cfg["max_length"]),
                         min(EOS_ID, self.cfg["vocab_size"] - 1), dtype=torch.long)
        ids[:, 0] = min(BOS_ID, self.cfg["vocab_size"] - 2)
        return ids


def build(config: dict, device="meta") -> dict:
    """The configuration's modules on ``device``, their parameters uninitialised
    (on the meta device, allocated nowhere): ``unet``, ``vae``, ``text`` and,
    with a second encoder, ``text2``."""
    parts = {"unet": UNet, "vae": VAE, "text": TextEncoder, "text2": TextEncoder}
    with torch.device(device):
        return {name: cls(config[name]).eval().requires_grad_(False)
                for name, cls in parts.items() if config.get(name)}
