"""Image-quality evaluation: CLIP image-text similarity (the port of
``gswm.eval.quality``).

Parity with the reference's compiled-only optim_utils.measure_similarity
(SURVEY.md §2.3) — the score used to verify the watermark is
performance-lossless.  The JAX package runs transformers' ``FlaxCLIPModel``
and ``CLIPProcessor`` from a local checkpoint directory; the port reads the
same directory by hand (``models.loader.load_clip``: ``config.json``,
``model.safetensors``; ``models.tokenizer``: ``vocab.json``, ``merges.txt``;
``preprocessor_config.json``) and runs ``models.clip.ClipModel`` on a torch
device.  The image processing is ``CLIPImageProcessor``'s, in torch: the
reference's uint8 truncation of arrays, the shortest edge to ``size`` by
PIL's bicubic resampling (its fixed-point coefficients and rounding, the
width then the height: equal to PIL's bytes), a center crop, rescale and
normalize.
Prompts are tokenized untruncated and padded to the longest, as
``CLIPProcessor(padding=True)`` does; the causal mask keeps the pooled EOS
state clear of the pads.
"""

from __future__ import annotations

import functools
import json
import math
import os

import numpy as np
import torch

# PIL's resampling filters by number, as preprocessor_config.json names them
_BICUBIC = 3
# the fractional bits of PIL's 8-bit resampling coefficients (Resample.c)
_PIL_PRECISION_BITS = 32 - 8 - 2


@functools.lru_cache(maxsize=4)
def _load_clip(model_dir: str, device: str):
    """(model on ``device``, tokenizer, processor settings) of a local CLIP
    directory, once per (model_dir, device)."""
    from gswm_torch.models.loader import load_clip
    from gswm_torch.models.tokenizer import load_tokenizer

    with open(os.path.join(model_dir, "preprocessor_config.json")) as f:
        proc = json.load(f)
    return load_clip(model_dir).to(device), load_tokenizer(model_dir), proc


def _edge(value, key: str) -> int:
    """A size entry of preprocessor_config.json: an int, or a dict holding
    ``key``."""
    return value if isinstance(value, int) else value[key]


def _as_uint8(images, device) -> torch.Tensor:
    """(B, 3, H, W) uint8 on ``device``: a tensor or array in [0, 1]
    truncated as the reference's ``(a * 255).astype(uint8)`` (quality.py:
    38-41), or a list of PIL images (PIL imported here alone)."""
    if isinstance(images, (list, tuple)):
        arrs = [np.asarray(im.convert("RGB")) for im in images]
        return torch.from_numpy(np.stack(arrs)).permute(0, 3, 1, 2).to(device)
    x = torch.as_tensor(images).to(device, torch.float32)
    return (x * 255).to(torch.uint8)


def _bicubic(x: float) -> float:
    """PIL's bicubic filter (a = -0.5; support 2)."""
    a, x = -0.5, abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def pil_bicubic_weights(in_size: int, out_size: int) -> torch.Tensor:
    """(out_size, in_size) float64 matrix of PIL's 8-bit resampling
    coefficients along one axis (Pillow's Resample.c ``precompute_coeffs``,
    then ``normalize_coeffs_8bpc``): the filter widened by the downscale
    factor, each row normalized, then scaled to integers of
    ``_PIL_PRECISION_BITS`` fractional bits."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    w = torch.zeros((out_size, in_size), dtype=torch.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        k = [_bicubic((x - center + 0.5) / filterscale) for x in range(xmin, xmax)]
        total = sum(k)
        for x, kk in zip(range(xmin, xmax), k):
            kk = kk / total if total != 0.0 else kk
            w[xx, x] = math.trunc((-0.5 if kk < 0 else 0.5) + kk * (1 << _PIL_PRECISION_BITS))
    return w


def _pil_resample(x: torch.Tensor, size) -> torch.Tensor:
    """``PIL.Image.resize(size, BICUBIC)`` of (B, C, H, W) uint8-valued
    float64 images, exactly: the width pass, then the height pass (each
    skipped where that side keeps its size), each a fixed-point sum with
    PIL's rounding and clipping to uint8.  The sums are integers below 2^53,
    exact in float64 on any device."""
    half = float(1 << (_PIL_PRECISION_BITS - 1))
    unit = float(1 << _PIL_PRECISION_BITS)

    def to_uint8(acc):
        return torch.floor((acc + half) / unit).clamp_(0, 255)

    h, w = x.shape[-2:]
    if size[1] != w:
        x = to_uint8(x @ pil_bicubic_weights(w, size[1]).to(x.device).t())
    if size[0] != h:
        x = to_uint8(pil_bicubic_weights(h, size[0]).to(x.device) @ x)
    return x


def preprocess(images, proc: dict, device="cuda") -> torch.Tensor:
    """``CLIPImageProcessor`` in torch: images (see ``_as_uint8``) ->
    (B, 3, crop, crop) float32 ``pixel_values`` on ``device``."""
    if proc.get("resample", _BICUBIC) != _BICUBIC:
        raise NotImplementedError(f"resample {proc['resample']}: only bicubic ({_BICUBIC})")
    x = _as_uint8(images, device).to(torch.float64)
    if proc.get("do_resize", True):
        short = _edge(proc["size"], "shortest_edge")
        h, w = x.shape[-2:]
        x = _pil_resample(x, (short, int(short * w / h)) if h <= w
                          else (int(short * h / w), short))
    if proc.get("do_center_crop", True):
        ch = _edge(proc["crop_size"], "height")
        cw = _edge(proc["crop_size"], "width")
        h, w = x.shape[-2:]
        top, left = (h - ch) // 2, (w - cw) // 2
        x = x[..., top:top + ch, left:left + cw]
    x = x.to(torch.float32)
    if proc.get("do_rescale", True):
        x = x * proc.get("rescale_factor", 1 / 255)
    if proc.get("do_normalize", True):
        mean = torch.tensor(proc["image_mean"], device=x.device).view(1, -1, 1, 1)
        std = torch.tensor(proc["image_std"], device=x.device).view(1, -1, 1, 1)
        x = (x - mean) / std
    return x


def tokenize(tokenizer, prompts, max_length: int) -> np.ndarray:
    """BOS + ids + EOS of each prompt, untruncated, padded with the pad
    token to the longest; a prompt longer than the text tower's
    ``max_length`` positions raises (the reference does not truncate it)."""
    rows = [[tokenizer.bos_token_id, *tokenizer.encode(p), tokenizer.eos_token_id]
            for p in prompts]
    longest = max(len(r) for r in rows)
    if longest > max_length:
        raise ValueError(f"a prompt of {longest} tokens; the text tower takes "
                         f"{max_length} positions and the score does not truncate")
    ids = np.full((len(rows), longest), tokenizer.pad_token_id, dtype=np.int64)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
    return ids


def measure_similarity(images, prompts, model_dir: str, device="cuda",
                       dtype: torch.dtype = torch.float32) -> np.ndarray:
    """Cosine similarity between image and text CLIP embeddings.

    images: list of PIL images or (B, 3, H, W) tensor or array in [0, 1];
    prompts: list of strings.  Returns (B,) float32 scores.  The model runs
    on ``device`` in ``dtype`` (float32, as the reference computes)."""
    model, tokenizer, proc = _load_clip(model_dir, str(torch.device(device)))
    model.to(dtype)
    pixels = preprocess(images, proc, device).to(dtype)
    ids = torch.from_numpy(tokenize(tokenizer, list(prompts), model.cfg.max_length))
    with torch.inference_mode():
        img, txt = model(pixels, ids.to(pixels.device))
    return (img * txt).sum(dim=-1).float().cpu().numpy()
