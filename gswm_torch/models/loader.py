"""Diffusers-layout checkpoints -> the port's modules (safetensors, offline).

Port of ``gswm.models.loader``.  A local checkpoint directory

    model_dir/
      unet/diffusion_pytorch_model.safetensors
      vae/diffusion_pytorch_model.safetensors
      text_encoder/model.safetensors
      text_encoder_2/model.safetensors      (SDXL)

is read by ``read_safetensors``, written here by hand: the safetensors
package is no dependency of the port.  The port's modules carry diffusers'
and transformers' own tensor names and layouts (tests/test_torch_manifest.py),
so the map is the identity but for what a checkpoint may carry and the port
does not:

  * the text encoders' ``position_ids`` buffer, dropped;
  * the legacy VAE attention names ``query / key / value / proj_attn``
    (diffusers before 0.14), mapped to ``to_q / to_k / to_v / to_out.0``;
  * SDXL's ``text_projection.weight`` of ``text_encoder_2/`` (a
    CLIPTextModelWithProjection), split off as the (in, out) projection
    of the pooled output.

``load_state_`` takes a state into a module (built on the meta device:
nothing is allocated that the checkpoint overwrites) and raises, naming the
missing, extra and misshapen keys, where the two do not match exactly.
"""

from __future__ import annotations

import json
import os
import re
import struct

import torch
from torch import nn

# safetensors dtype tags the reader takes (position_ids are stored I64)
_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
           "I64": torch.int64}
_LEGACY_VAE = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}
_DIFFUSERS_FILE = "diffusion_pytorch_model.safetensors"


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """A safetensors file -> {name: CPU tensor}: an 8-byte little-endian
    header length, a JSON header of ``dtype`` / ``shape`` / ``data_offsets``
    (into the bytes after the header; ``__metadata__`` skipped), the raw
    little-endian buffers.  F32, F16, BF16 and I64; anything else, or a
    buffer of the wrong length, raises."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which the "
                             f"reader does not take ({sorted(_DTYPES)})")
        dtype = _DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        shape = info["shape"]
        numel = 1
        for d in shape:
            numel *= d
        if end - start != numel * dtype.itemsize or end > len(data):
            raise ValueError(f"{path}: {name} spans bytes {start}..{end}, not "
                             f"{numel} x {dtype.itemsize} within {len(data)}")
        raw = torch.frombuffer(data, dtype=torch.uint8, count=end - start, offset=start) \
            if end > start else torch.empty(0, dtype=torch.uint8)
        if start % dtype.itemsize:  # a view needs an aligned offset
            raw = raw.clone()
        out[name] = raw.view(dtype).reshape(shape)
    return out


def load_unet_state(model_dir: str) -> dict[str, torch.Tensor]:
    return read_safetensors(os.path.join(model_dir, "unet", _DIFFUSERS_FILE))


def load_vae_state(model_dir: str) -> dict[str, torch.Tensor]:
    """The VAE's state, the legacy attention names mapped."""
    return {re.sub(r"\.(query|key|value|proj_attn)\.",
                   lambda m: f".{_LEGACY_VAE[m.group(1)]}.", k): v
            for k, v in read_safetensors(os.path.join(model_dir, "vae",
                                                       _DIFFUSERS_FILE)).items()}


def load_text_state(model_dir: str, sub: str = "text_encoder") -> dict[str, torch.Tensor]:
    """A CLIP text encoder's state from ``model_dir/sub/model.safetensors``,
    ``position_ids`` dropped."""
    state = read_safetensors(os.path.join(model_dir, sub, "model.safetensors"))
    return {k: v for k, v in state.items() if not k.endswith("position_ids")}


def load_text2_state(model_dir: str) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """SDXL's second encoder (``text_encoder_2/``): (its state, the float32
    (in, out) text_projection) — the checkpoint's (out, in)
    ``text_projection.weight`` transposed (gswm/models/loader.py:177-195)."""
    state = load_text_state(model_dir, "text_encoder_2")
    if "text_projection.weight" not in state:
        raise ValueError(f"{model_dir}/text_encoder_2 has no text_projection.weight")
    projection = state.pop("text_projection.weight").to(torch.float32).t().contiguous()
    return state, projection


def load_pipeline_states(model_dir: str, sdxl: bool) -> dict:
    """Every component's state: ``unet``, ``vae``, ``text`` and, for SDXL,
    ``text2`` and ``text2_projection``."""
    states = {"unet": load_unet_state(model_dir), "vae": load_vae_state(model_dir),
              "text": load_text_state(model_dir)}
    if sdxl:
        states["text2"], states["text2_projection"] = load_text2_state(model_dir)
    return states


def load_state_(module: nn.Module, state: dict, what: str) -> nn.Module:
    """Take ``state`` into ``module`` by assignment (floating tensors as
    float32, the modules' dtype before any cast); raise naming the missing,
    extra and misshapen keys where the two differ (the JAX package's
    ``_check_against``)."""
    target = module.state_dict()
    missing = sorted(set(target) - set(state))
    extra = sorted(set(state) - set(target))
    misshapen = [f"{k}: checkpoint {tuple(state[k].shape)} vs model "
                 f"{tuple(target[k].shape)}" for k in sorted(set(state) & set(target))
                 if tuple(state[k].shape) != tuple(target[k].shape)]
    if missing or extra or misshapen:
        raise ValueError(f"{what} checkpoint/model mismatch: missing {missing[:20]}, "
                         f"extra {extra[:20]}, misshapen {misshapen[:20]}")
    module.load_state_dict(
        {k: v.to(torch.float32) if v.is_floating_point() else v for k, v in state.items()},
        strict=True, assign=True)
    return module
