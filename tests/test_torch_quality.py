"""The CLIP quality score of the port (``gswm_torch.eval.quality``,
``models.clip``, ``models.bridge.clip_from_flax``, ``models.loader.load_clip``)
against the JAX package's (``gswm.eval.quality``: transformers'
``FlaxCLIPModel`` and ``CLIPProcessor``) on one tiny CLIP directory: a
``FlaxCLIPModel`` of a tiny ``CLIPConfig``, random weights from a seed, saved
with a tiny vocabulary, its processor and, for the port's loader, the same
weights as ``model.safetensors``.

Tolerances: embeddings within 1e-4 (float32 both sides); ``pixel_values``
within 1e-6 (the port resamples with PIL's fixed-point coefficients and
rounding, so the resized bytes are PIL's; what is left is float32
arithmetic); scores within 5e-3."""

import json

import numpy as np
import pytest
import torch

import gswm.eval.quality as jquality
from gswm_torch.eval import quality
from gswm_torch.models import bridge, clip, loader
from test_torch_tokenizer import write_vocab

PROMPTS = ["a cat", "an astronaut riding a horse on the moon", "dog", "", "a red apple",
           "café crème", "oil painting of the sea at night", "x"]


def _config(vocab, eos=None, image_size=32, patch=4):
    return dict(
        text_config=dict(vocab_size=len(vocab), hidden_size=32, intermediate_size=64,
                         num_hidden_layers=2, num_attention_heads=2,
                         max_position_embeddings=77,
                         eos_token_id=vocab["<|endoftext|>"] if eos is None else eos,
                         bos_token_id=vocab["<|startoftext|>"],
                         pad_token_id=vocab["<|endoftext|>"]),
        vision_config=dict(hidden_size=32, intermediate_size=96, num_hidden_layers=2,
                           num_attention_heads=4, image_size=image_size, patch_size=patch,
                           hidden_act="gelu"),
        projection_dim=16)


def _write_clip(directory, eos=None, seed=0):
    """A tiny CLIP directory as transformers writes it, plus model.safetensors
    (position_ids included, as CLIPModel's state carries them)."""
    from safetensors.numpy import save_file
    from transformers import (CLIPConfig, CLIPImageProcessor, CLIPProcessor,
                              CLIPTokenizer, FlaxCLIPModel)

    write_vocab(directory)
    vocab = json.loads((directory / "vocab.json").read_text())
    config = _config(vocab, eos)
    flax_model = FlaxCLIPModel(CLIPConfig(**config), seed=seed)
    flax_model.save_pretrained(directory)
    processor = CLIPProcessor(
        image_processor=CLIPImageProcessor(size={"shortest_edge": 32},
                                           crop_size={"height": 32, "width": 32}),
        tokenizer=CLIPTokenizer(str(directory / "vocab.json"),
                                str(directory / "merges.txt")))
    processor.save_pretrained(directory)
    model = bridge.clip_from_flax(flax_model.params, config)
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    state["text_model.embeddings.position_ids"] = np.arange(77, dtype=np.int64)[None]
    state["vision_model.embeddings.position_ids"] = np.arange(65, dtype=np.int64)[None]
    save_file(state, str(directory / "model.safetensors"))
    return flax_model, config, model


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    directory = tmp_path_factory.mktemp("clip")
    flax_model, config, model = _write_clip(directory)
    return str(directory), flax_model, config, model


def _images(n=3, h=40, w=48, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, 3, h, w)).astype(np.float32)


@pytest.mark.parametrize("eos", [None, 2], ids=["eos_id", "legacy_eos_2"])
def test_towers_match_flax_clip(tmp_path, eos):
    """``clip_from_flax`` and the port's towers against ``FlaxCLIPModel``'s
    unit-length image and text embeddings, within 1e-4, under both pooling
    rules (the first EOS, and the largest id under eos_token_id 2)."""
    from transformers import CLIPTokenizer

    flax_model, _, model = _write_clip(tmp_path, eos, seed=3)
    tok = CLIPTokenizer(str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt"))
    enc = tok(PROMPTS, padding=True, return_tensors="np")
    pixels = np.random.default_rng(1).normal(size=(len(PROMPTS), 3, 32, 32)).astype(np.float32)
    out = flax_model(input_ids=enc["input_ids"], pixel_values=pixels,
                     attention_mask=enc["attention_mask"])
    with torch.inference_mode():
        img, txt = model(torch.from_numpy(pixels), torch.from_numpy(enc["input_ids"]))
    np.testing.assert_allclose(img.numpy(), np.asarray(out.image_embeds), atol=1e-4)
    np.testing.assert_allclose(txt.numpy(), np.asarray(out.text_embeds), atol=1e-4)


def test_load_clip_equals_the_bridged_model(clip_dir):
    """``load_clip`` reads config.json and model.safetensors by hand (the
    position_ids buffers dropped): every tensor equal to the bridged
    model's."""
    directory, _, _, model = clip_dir
    loaded = loader.load_clip(directory)
    want = model.state_dict()
    got = loaded.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert loaded.cfg.eos_token_id == model.cfg.eos_token_id


@pytest.mark.parametrize("shape", [(3, 40, 48), (3, 64, 40), (3, 32, 32), (3, 97, 31),
                                   (3, 20, 16)],
                         ids=lambda s: "x".join(map(str, s[1:])))
def test_processor_matches_clip_processor(clip_dir, shape):
    """The torch processor's ``pixel_values`` against ``CLIPProcessor``'s on
    the reference's uint8 images (down- and upscaled): within 1e-6."""
    from PIL import Image
    from transformers import CLIPProcessor

    directory = clip_dir[0]
    arr = np.random.default_rng(7).uniform(0, 1, (2,) + shape).astype(np.float32)
    pil = [Image.fromarray((a.transpose(1, 2, 0) * 255).astype(np.uint8)) for a in arr]
    want = CLIPProcessor.from_pretrained(directory, local_files_only=True)(
        images=pil, return_tensors="np")["pixel_values"]
    proc = json.loads(open(f"{directory}/preprocessor_config.json").read())
    got = quality.preprocess(arr, proc, "cpu").numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # PIL images take the same path from their uint8 pixels
    np.testing.assert_array_equal(quality.preprocess(pil, proc, "cpu").numpy(), got)


@pytest.mark.parametrize("images", ["array", "tensor", "pil"])
def test_measure_similarity_matches_jax(clip_dir, images):
    """``measure_similarity`` against ``gswm.eval.quality``'s on the same
    directory and inputs: within 5e-3."""
    from PIL import Image

    directory = clip_dir[0]
    arr = _images(len(PROMPTS))
    want = jquality.measure_similarity(arr, PROMPTS, directory)
    given = {"array": arr, "tensor": torch.from_numpy(arr),
             "pil": [Image.fromarray((a.transpose(1, 2, 0) * 255).astype(np.uint8))
                     for a in arr]}[images]
    got = quality.measure_similarity(given, PROMPTS, directory, device="cpu")
    assert got.shape == (len(PROMPTS),) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), atol=5e-3)


@pytest.mark.parametrize("sizes", [(512, 224), (768, 224), (224, 224), (31, 224), (97, 32)])
def test_resampling_is_pils_byte_for_byte(sizes):
    """``PIL.Image.resize(..., BICUBIC)`` of uint8 noise, reproduced exactly
    (the width pass, then the height pass, PIL's fixed-point sums)."""
    from PIL import Image

    (h, w), (oh, ow) = (sizes[0], sizes[0] + 17), (sizes[1], sizes[1] + 5)
    arr = (np.random.default_rng(h).uniform(size=(h, w, 3)) * 255).astype(np.uint8)
    want = np.asarray(Image.fromarray(arr).resize((ow, oh), Image.BICUBIC))
    got = quality._pil_resample(torch.from_numpy(arr).permute(2, 0, 1)[None].double(),
                                (oh, ow))
    np.testing.assert_array_equal(got[0].permute(1, 2, 0).numpy(), want)


def test_long_prompts_are_refused_not_truncated(clip_dir):
    """Over 77 tokens neither side truncates: the reference's model fails on
    the positions, the port refuses before it runs."""
    directory = clip_dir[0]
    long = ["a cat " * 60, "dog"]
    with pytest.raises(TypeError):
        jquality.measure_similarity(_images(2), long, directory)
    with pytest.raises(ValueError, match="does not truncate"):
        quality.measure_similarity(_images(2), long, directory, device="cpu")


def test_clip_config_reads_transformers_defaults():
    """Keys a config.json leaves out take transformers' defaults; the ViT-L/14
    widths of tools/paths.py build on the meta device."""
    from gswm_torch.tools import paths

    cfg = clip.config_from_dict({})
    assert (cfg.text.hidden_size, cfg.vision.patch_size, cfg.projection_dim) == (512, 32, 512)
    big = clip.config_from_dict(paths.CLIP_VIT_L14)
    assert (big.vision.hidden_size, big.vision.num_layers, big.vision.num_heads,
            big.vision.patch_size, big.vision.image_size) == (1024, 24, 16, 14, 224)
    assert (big.text.hidden_size, big.text.num_layers, big.text.num_heads,
            big.projection_dim) == (768, 12, 12, 768)
    with torch.device("meta"):
        model = clip.ClipModel(big)
    n = sum(p.numel() for p in model.parameters())
    assert 420e6 < n < 435e6, n  # ViT-L/14 CLIP: 427.6M parameters


def test_write_safetensors_is_read_by_the_safetensors_package(tmp_path):
    """The port's writer (used where the package is not installed) against
    the package's reader, every dtype the port's reader takes."""
    from safetensors.torch import load_file

    state = {"w": torch.randn(3, 5), "h": torch.randn(7).half(), "b": torch.randn(2, 2).bfloat16(),
             "ids": torch.arange(6).reshape(1, 6), "scalar": torch.tensor(2.5),
             "empty": torch.zeros(0, 4)}
    loader.write_safetensors(str(tmp_path / "x.safetensors"), state)
    for got in (load_file(str(tmp_path / "x.safetensors")),
                loader.read_safetensors(str(tmp_path / "x.safetensors"))):
        assert sorted(got) == sorted(state)
        for k, v in state.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_build_clip_is_seeded():
    cfg = _config({"<|endoftext|>": 10, "<|startoftext|>": 9, **{str(i): i for i in range(9)}})
    a = clip.build_clip(cfg, torch.Generator().manual_seed(4), device="cpu")
    b = clip.build_clip(cfg, torch.Generator().manual_seed(4), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    assert a.logit_scale.item() == pytest.approx(clip.LOGIT_SCALE_INIT)


# -- the ranking cases of tests/test_quality_eval.py, through a stand-in model


class _FakeModel(torch.nn.Module):
    """Deterministic stand-in with ClipModel's call contract: the image
    embed is the mean of each channel, the text embed all ones on the first
    len(ids) % 3 + 1 entries, so aligned pairs score high."""

    cfg = clip.config_from_dict({}).text

    def forward(self, pixel_values, input_ids):
        img = pixel_values.reshape(pixel_values.shape[0], 3, -1).mean(dim=-1)
        txt = torch.zeros((input_ids.shape[0], 3))
        for i, row in enumerate(input_ids):
            txt[i, :row.shape[0] % 3 + 1] = 1.0
            txt[i] += 1e-3 * row.sum()
        return (torch.nn.functional.normalize(img, dim=-1),
                torch.nn.functional.normalize(txt, dim=-1))


class _FakeTokenizer:
    bos_token_id, eos_token_id, pad_token_id = 1, 2, 0

    def encode(self, text):
        return list(text.encode()[:8])


_PLAIN = {"do_resize": False, "do_center_crop": False, "do_normalize": False}


@pytest.fixture
def stub_clip(monkeypatch):
    monkeypatch.setattr(quality, "_load_clip",
                        lambda model_dir, device: (_FakeModel(), _FakeTokenizer(), _PLAIN))


def test_measure_similarity_array_input(stub_clip):
    scores = quality.measure_similarity(_images(3, 16, 16), ["a", "bb", "ccc"],
                                        "/nonexistent", device="cpu")
    assert scores.shape == (3,)
    assert np.all(scores <= 1.0 + 1e-6) and np.all(scores >= -1.0 - 1e-6)


def test_measure_similarity_identical_embeds_score_one(stub_clip):
    from PIL import Image

    img = Image.new("RGB", (8, 8), (255, 255, 255))
    scores = quality.measure_similarity([img, img], ["xy", "xy"], "/nope", device="cpu")
    np.testing.assert_allclose(scores, scores[::-1])
    assert scores[0] > 0.6


def test_measure_similarity_ranks_aligned_pairs_higher(stub_clip):
    from PIL import Image

    white = Image.new("RGB", (8, 8), (255, 255, 255))
    red = Image.new("RGB", (8, 8), (255, 0, 0))
    s = quality.measure_similarity([white, red], ["xy", "xy"], "/nope", device="cpu")
    assert s[0] > s[1]
