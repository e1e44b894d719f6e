"""The port's modules carry the checkpoint's own tensor names and shapes.

tests/fixtures/*_manifest.json hold the name -> shape maps of the real
diffusers / transformers checkpoints (SD 1.4 and SD 2.1: UNet, VAE, text
encoder).  On the meta device (nothing is allocated) the port's
``state_dict()`` must have exactly those names and shapes, so a loader is the
identity map but for two things a checkpoint may carry and the port does not:
the text encoder's ``position_ids`` buffer, and the legacy VAE attention names
``query / key / value / proj_attn`` (gswm/models/loader.py:83-86).
"""

import json
import re
from pathlib import Path

import pytest
import torch

from gswm_torch.models.configs import PRESETS
from gswm_torch.models.text import TextEncoder
from gswm_torch.models.unet import UNet2DCondition
from gswm_torch.models.vae import AutoencoderKL

FIXTURES = Path(__file__).parent / "fixtures"
PARTS = {"unet": (UNet2DCondition, 686), "vae": (AutoencoderKL, 248),
         "text": (TextEncoder, None)}
TEXT_TENSORS = {"sd14": 196, "sd21": 372}
LEGACY_VAE = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}


def checkpoint_names(manifest: dict) -> dict:
    """A checkpoint's names as the port spells them: ``position_ids`` dropped,
    legacy VAE attention names mapped."""
    out = {}
    for name, shape in manifest.items():
        if name.endswith("position_ids"):
            continue
        name = re.sub(r"\.(query|key|value|proj_attn)\.",
                      lambda m: f".{LEGACY_VAE[m.group(1)]}.", name)
        out[name] = list(shape)
    return out


@pytest.mark.parametrize("part", list(PARTS))
@pytest.mark.parametrize("fixture,preset", [("sd14", "sd-1-4"), ("sd21", "sd-2-1")])
def test_state_dict_equals_checkpoint_manifest(fixture, preset, part):
    manifest = json.loads((FIXTURES / f"{fixture}_{part}_manifest.json").read_text())
    cls, count = PARTS[part]
    assert len(manifest) == (count or TEXT_TENSORS[fixture])
    with torch.device("meta"):
        module = cls(getattr(PRESETS[preset], part))
    ours = {name: list(t.shape) for name, t in module.state_dict().items()}
    want = checkpoint_names(manifest)
    assert sorted(set(want) - set(ours)) == [], "missing from the port"
    assert sorted(set(ours) - set(want)) == [], "not in the checkpoint"
    assert {k: v for k, v in ours.items() if v != want[k]} == {}
    assert all(t.device.type == "meta" for t in module.state_dict().values())


def test_legacy_names_and_position_ids_are_what_a_loader_maps():
    legacy = {"encoder.mid_block.attentions.0.query.weight": [512, 512],
              "encoder.mid_block.attentions.0.proj_attn.bias": [512],
              "text_model.embeddings.position_ids": [1, 77]}
    assert checkpoint_names(legacy) == {
        "encoder.mid_block.attentions.0.to_q.weight": [512, 512],
        "encoder.mid_block.attentions.0.to_out.0.bias": [512]}
    with torch.device("meta"):
        vae = AutoencoderKL(PRESETS["sd-2-1"].vae)
    assert set(checkpoint_names(legacy)) <= set(vae.state_dict())
