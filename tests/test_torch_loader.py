"""The port's checkpoint loader and cache (``gswm_torch.models.loader``,
``gswm_torch.models.cache``).

Diffusers-layout directories are written from the JAX package's tiny and
tiny-xl pipelines' weights (through the bridge's names) with
``safetensors.numpy.save_file``; the safetensors package is used by this
test alone.  ``InversablePipeline(model_dir=...)`` must then hold the same
tensors as a pipeline given the same trees through the bridge, tensor for
tensor; the hand-written reader must equal ``safetensors.numpy.load_file``
in F32, F16 and BF16.
"""

import os
import re

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from gswm.pipelines import InversablePipeline as JPipeline
from gswm_torch.models import cache, loader
from gswm_torch.models.bridge import convert_tree, load_pipeline_params_
from gswm_torch.pipelines import InversablePipeline
from gswm_torch.pipelines import inversable

torch.set_num_threads(2)

LEGACY = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}


def _np(state: dict) -> dict:
    return {k: v.numpy().astype(np.float32) for k, v in state.items()}


def _write_dir(root, jpipe, legacy_vae=False):
    """A diffusers-layout checkpoint of the JAX pipeline's trees; the text
    encoders carry ``position_ids``, SDXL's second one a text_projection."""
    def save(sub, name, state):
        os.makedirs(root / sub, exist_ok=True)
        save_file(state, str(root / sub / name), metadata={"format": "pt"})

    vae = _np(convert_tree(jpipe.vae_params))
    if legacy_vae:
        vae = {re.sub(r"\.(to_q|to_k|to_v|to_out\.0)\.",
                      lambda m: f".{LEGACY[m.group(1)]}.", k): v for k, v in vae.items()}
    save("unet", "diffusion_pytorch_model.safetensors",
         _np(convert_tree(jpipe.unet_params)))
    save("vae", "diffusion_pytorch_model.safetensors", vae)
    pos = {"text_model.embeddings.position_ids": np.arange(77, dtype=np.int64)[None]}
    save("text_encoder", "model.safetensors", {**_np(convert_tree(jpipe.text_params)), **pos})
    projection = None
    if jpipe.text2 is not None:
        hidden = jpipe.preset.text2.hidden_size
        projection = np.random.default_rng(3).standard_normal(
            (hidden, hidden)).astype(np.float32)  # (in, out)
        save("text_encoder_2", "model.safetensors",
             {**_np(convert_tree(jpipe.text2.params)), **pos,
              "text_projection.weight": np.ascontiguousarray(projection.T)})
    return projection


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """{preset: (JAX pipeline, model_dir, projection)}, and a tiny directory
    with the legacy VAE names."""
    out = {}
    for preset in ("tiny", "tiny-xl"):
        jpipe = JPipeline(preset, dtype=jnp.float32)
        root = tmp_path_factory.mktemp(preset)
        out[preset] = (jpipe, str(root), _write_dir(root, jpipe))
    legacy = tmp_path_factory.mktemp("legacy")
    _write_dir(legacy, out["tiny"][0], legacy_vae=True)
    out["legacy"] = (out["tiny"][0], str(legacy), None)
    return out


@pytest.mark.parametrize("dtype", ["F32", "F16", "BF16"])
def test_reader_equals_safetensors_load_file(tmp_path, dtype):
    np_dtype = {"F32": np.float32, "F16": np.float16, "BF16": ml_dtypes.bfloat16}[dtype]
    rng = np.random.default_rng(1)
    arrays = {"conv.weight": rng.standard_normal((4, 3, 3, 3)),
              "odd": rng.standard_normal(7), "scalar": np.asarray(2.5),
              "empty": np.zeros((0, 5))}
    arrays = {k: v.astype(np_dtype) for k, v in arrays.items()}
    arrays["ids"] = np.arange(9, dtype=np.int64).reshape(3, 3)
    path = str(tmp_path / "x.safetensors")
    save_file(arrays, path, metadata={"format": "pt", "note": "skipped"})
    want = load_file(path)
    got = loader.read_safetensors(path)
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        t = got[name]
        assert tuple(t.shape) == arr.shape
        assert t.dtype == (torch.int64 if name == "ids" else {
            "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}[dtype])
        assert t.reshape(-1).view(torch.uint8).numpy().tobytes() == arr.tobytes(), name


def test_reader_refuses_what_it_cannot_read(tmp_path):
    path = str(tmp_path / "f64.safetensors")
    save_file({"w": np.ones(3, np.float64)}, path)
    with pytest.raises(ValueError, match="F64"):
        loader.read_safetensors(path)
    good = str(tmp_path / "ok.safetensors")
    save_file({"w": np.ones(4, np.float32)}, good)
    data = bytearray(open(good, "rb").read())
    with open(good, "wb") as f:
        f.write(bytes(data[:-4]))  # one float short
    with pytest.raises(ValueError, match="spans bytes"):
        loader.read_safetensors(good)


@pytest.mark.parametrize("preset", ["tiny", "tiny-xl", "legacy"])
def test_model_dir_loads_what_the_bridge_loads(checkpoints, monkeypatch, preset):
    """Every component, tensor for tensor: the text encoders without their
    position_ids, text2's projection split off and transposed, the legacy
    VAE names mapped.  Nothing is filled with random weights first."""
    jpipe, model_dir, projection = checkpoints[preset]
    name = "tiny" if preset == "legacy" else preset
    want = load_pipeline_params_(
        InversablePipeline(name, device="cpu", dtype=torch.float32), jpipe.unet_params,
        jpipe.vae_params, jpipe.text_params,
        None if jpipe.text2 is None else jpipe.text2.params, projection)

    def no_fill(*args, **kwargs):
        raise AssertionError("model_dir loading filled random weights")

    monkeypatch.setattr(inversable, "init_random_", no_fill)
    got = InversablePipeline(name, device="cpu", dtype=torch.float32, model_dir=model_dir)
    parts = ["unet", "vae", "text"] + (["text2"] if jpipe.text2 is not None else [])
    for part in parts:
        a, b = getattr(got, part).state_dict(), getattr(want, part).state_dict()
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].device.type == "cpu" and a[k].dtype == b[k].dtype
            assert torch.equal(a[k], b[k]), f"{part}.{k}"
    if projection is None:
        assert got.text2_projection is None
    else:
        assert torch.equal(got.text2_projection, torch.from_numpy(projection))
        assert torch.equal(got.text2_projection, want.text2_projection)
        torch.testing.assert_close(got.pooled_empty_text(2), want.pooled_empty_text(2),
                                   rtol=0, atol=0)


def test_model_dir_in_bf16_with_weights_dtype(checkpoints):
    """The compute dtype and the weights' rounding apply to loaded weights
    as to random ones: norms float32, the rest bf16, every value bf16's."""
    _, model_dir, _ = checkpoints["tiny-xl"]
    pipe = InversablePipeline("tiny-xl", device="cpu", dtype=torch.bfloat16,
                              model_dir=model_dir, weights_dtype=torch.bfloat16)
    assert pipe.unet.conv_norm_out.weight.dtype == torch.float32
    assert pipe.unet.conv_in.weight.dtype == torch.bfloat16
    w = pipe.unet.conv_norm_out.weight
    assert torch.equal(w, w.bfloat16().float())
    assert pipe.text2.text_model.final_layer_norm.weight.dtype == torch.float32


@pytest.mark.parametrize("fault", ["extra", "missing", "misshapen"])
def test_a_key_that_cannot_be_placed_raises(checkpoints, tmp_path, fault):
    jpipe, _, _ = checkpoints["tiny"]
    state = _np(convert_tree(jpipe.unet_params))
    key = "conv_in.weight"
    if fault == "extra":
        state["conv_in.extra"] = np.ones(2, np.float32)
        key = "conv_in.extra"
    elif fault == "missing":
        del state[key]
    else:
        state[key] = state[key][:, :2]
    os.makedirs(tmp_path / "unet")
    save_file(state, str(tmp_path / "unet" / "diffusion_pytorch_model.safetensors"))
    from gswm_torch.models.configs import PRESETS
    from gswm_torch.models.unet import UNet2DCondition

    with torch.device("meta"):
        unet = UNet2DCondition(PRESETS["tiny"].unet)
    with pytest.raises(ValueError, match=re.escape(key)) as err:
        loader.load_state_(unet, loader.load_unet_state(str(tmp_path)), "unet")
    assert fault in str(err.value)


def test_cache_round_trips(tmp_path):
    model_dir, cache_dir = tmp_path / "ckpt", str(tmp_path / "cache")
    model_dir.mkdir()
    calls = []

    def convert():
        calls.append(1)
        return {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(2, dtype=torch.bfloat16)}

    first = cache.load_or_convert(cache_dir, str(model_dir), "vae", convert)
    second = cache.load_or_convert(cache_dir, str(model_dir), "vae", convert)
    assert len(calls) == 1
    assert sorted(second) == ["b", "w"]
    assert all(torch.equal(first[k], second[k]) and first[k].dtype == second[k].dtype
               for k in first)
    files = os.listdir(cache_dir)
    assert len(files) == 1 and re.fullmatch(r"vae_[0-9a-f]{16}\.pt", files[0])
    assert cache.load_state(cache_dir, str(model_dir), "unet") is None
    os.utime(model_dir, (1, 1))  # a new mtime is a new key
    assert cache.load_state(cache_dir, str(model_dir), "vae") is None
    assert cache.cache_path(cache_dir, str(tmp_path / "gone"), "vae").endswith(".pt")
