"""The host surfaces of the port (``gswm_torch.integrations``: the ComfyUI
node pair, the A1111 script, their shims; ``gswm_torch.examples``) against the
JAX package's (``gswm.integrations``), on the CPU.

The latents are held against the JAX functions' on the JAX side's own
uniform draws: the quantized bits equal, the values within the few fp32 ulps
by which the two libraries' ndtri differ (tests/test_torch_core.py: 4e-6).
The hosts are stubs: ``comfy`` / ``latent_preview`` for ComfyUI, ``gradio`` /
``modules.*`` of both WebUI generations for A1111."""

import importlib.machinery
import json
import runpy
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import gswm.integrations.a1111 as ja1111
import gswm.integrations.comfyui as jcomfy
from gswm_torch.config import GSConfig
from gswm_torch.core.decode import decode_latents
from gswm_torch.eval.metrics import calculate_bit_accuracy
from gswm_torch.integrations import a1111, comfyui

PORT = Path(__file__).resolve().parents[1] / "gswm_torch"
KEY, NONCE = "22" * 32, "33" * 16
NDTRI_ATOL = 4e-6


@pytest.fixture
def on_cpu(monkeypatch, tmp_path):
    """The node embeds on the CPU; registry files go to a temporary
    directory."""
    monkeypatch.setattr(comfyui.GSLatent, "device", "cpu")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _jax_uniforms(seed: int, elements: int) -> np.ndarray:
    """The draws the JAX package makes for one seeded latent."""
    return np.asarray(jax.random.uniform(jax.random.key(seed), (1, elements)))


def _bits_of(lat) -> np.ndarray:
    return (np.asarray(lat) > 0)


# -- ComfyUI ------------------------------------------------------------------

def test_comfyui_gslatent_node(on_cpu):
    node = comfyui.GSLatent()
    (latent, preview) = node.create_gs_latents(
        key=KEY, nonce=NONCE, message="lthero", batch_size=3,
        use_seed=1, seed=7, width=512, height=512, message_length=256,
    )
    t = latent["samples"]
    assert tuple(t.shape) == (3, 4, 64, 64)
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    # seeded -> replicated across batch (nodes.py:232-238)
    assert torch.equal(t[0], t[1]) and torch.equal(t[1], t[2])
    assert (on_cpu / "info_data.txt").exists()
    assert tuple(preview.shape) == (3, 64, 64, 3)
    assert 0.0 <= preview.min() and preview.max() <= 1.0
    # unseeded -> independent
    (latent2, _) = node.create_gs_latents(
        key=KEY, nonce=NONCE, message="lthero", batch_size=2,
        use_seed=0, seed=7, width=512, height=512, message_length=256,
    )
    t2 = latent2["samples"]
    assert not torch.allclose(t2[0], t2[1])
    # each decodes to the message under the key
    cfg = GSConfig(key_hex=KEY, nonce_hex=NONCE, message_bits=256)
    for row in torch.cat([t[:1], t2]):
        _, acc = calculate_bit_accuracy((b"lthero" + b"\0" * 26).hex(), decode_latents(row, cfg))
        assert acc == 1.0


def test_comfyui_node_latent_equals_jax_on_the_jax_draws(on_cpu):
    """The seeded latent of both packages' ``gs_watermark_init_noise``, the
    port given the uniforms jax.random.key(seed) draws; and the node's
    metadata the JAX node's."""
    args = (KEY, NONCE, "cpu", "lthero", 1, 7, 512, 640)
    want = jcomfy.gs_watermark_init_noise(*args, message_length=128).numpy()
    u = _jax_uniforms(7, want.size)
    got = comfyui.gs_watermark_init_noise(*args, message_length=128, u=u)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (4, 80, 64)
    np.testing.assert_array_equal(_bits_of(got), _bits_of(want))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=NDTRI_ATOL)
    assert comfyui.GSLatent.INPUT_TYPES() == jcomfy.GSLatent.INPUT_TYPES()
    assert comfyui.GSLatent.RETURN_TYPES == jcomfy.GSLatent.RETURN_TYPES
    # two records, each in the reference's format
    assert (on_cpu / "info_data.txt").read_text().count("key: " + KEY) == 2


def _stub_comfy(monkeypatch, calls: list):
    """Stub ``comfy.sample`` / ``comfy.utils`` / ``comfy.samplers`` and
    ``latent_preview``; ``comfy.sample.sample`` records the noise it is
    handed and returns it plus the latent."""
    comfy = types.ModuleType("comfy")
    sample = types.ModuleType("comfy.sample")
    utils = types.ModuleType("comfy.utils")
    samplers = types.ModuleType("comfy.samplers")
    preview = types.ModuleType("latent_preview")

    def prepare_noise(latent_image, seed, batch_inds):
        return torch.randn(latent_image.shape, generator=torch.Generator().manual_seed(seed))

    def run(model, noise, steps, cfg, sampler_name, scheduler, positive, negative,
            latent_image, **kw):
        calls.append({"noise": noise.clone(), "steps": steps, "cfg": cfg,
                      "sampler_name": sampler_name, "scheduler": scheduler,
                      **{k: v for k, v in kw.items() if k not in ("callback", "noise_mask")}})
        return noise + latent_image

    sample.prepare_noise, sample.sample = prepare_noise, run
    utils.PROGRESS_BAR_ENABLED = False
    samplers.KSampler = types.SimpleNamespace(SAMPLERS=["euler", "dpmpp_2m"],
                                              SCHEDULERS=["normal", "karras"])
    preview.prepare_callback = lambda model, steps: None
    comfy.sample, comfy.utils, comfy.samplers = sample, utils, samplers
    for name, mod in (("comfy", comfy), ("comfy.sample", sample), ("comfy.utils", utils),
                      ("comfy.samplers", samplers), ("latent_preview", preview)):
        monkeypatch.setitem(sys.modules, name, mod)


@pytest.mark.parametrize("mode", ["gs", "no_noise", "seeded_noise"])
def test_common_ksampler_hands_the_gs_latent_to_the_sampler(on_cpu, monkeypatch, mode):
    """Both packages' ``GSKSamplerAdvanced.sample`` under stub ComfyUI
    modules: with GS noise enabled the noise handed to ``comfy.sample`` is
    the GS latent itself; otherwise zeros, or the seeded noise; every other
    argument the JAX node passes, the port's passes."""
    calls = []
    _stub_comfy(monkeypatch, calls)
    (gs, _) = comfyui.GSLatent().create_gs_latents(
        key=KEY, nonce=NONCE, message="lthero", batch_size=2, use_seed=1, seed=3,
        width=64, height=64, message_length=32)
    empty = {"samples": torch.zeros((2, 4, 8, 8))}
    flags = {"gs": ("enable", "disable"), "no_noise": ("disable", "disable"),
             "seeded_noise": ("disable", "enable")}[mode]
    kw = dict(model=object(), add_GS_noise=flags[0], add_noise=flags[1], noise_seed=5,
              steps=20, cfg=8.0, sampler_name="dpmpp_2m", scheduler="karras",
              positive=[], negative=[], latent_image=empty, GS_latent_noise=gs,
              start_at_step=0, end_at_step=10000, return_with_leftover_noise="disable")
    (out,) = comfyui.GSKSamplerAdvanced().sample(**kw)
    (jout,) = jcomfy.GSKSamplerAdvanced().sample(**kw)
    assert comfyui.GSKSamplerAdvanced.INPUT_TYPES() == jcomfy.GSKSamplerAdvanced.INPUT_TYPES()
    port_call, jax_call = calls
    want_noise = {"gs": gs["samples"], "no_noise": torch.zeros((2, 4, 8, 8)),
                  "seeded_noise": torch.randn((2, 4, 8, 8),
                                              generator=torch.Generator().manual_seed(5))}[mode]
    assert torch.equal(port_call["noise"], want_noise)
    assert torch.equal(out["samples"], want_noise)
    assert port_call.keys() == jax_call.keys()
    for k in port_call:
        if k != "noise":
            assert port_call[k] == jax_call[k], k
    assert torch.equal(jout["samples"], jax_call["noise"])


# -- A1111 --------------------------------------------------------------------

def test_a1111_noise_batch_decodes(on_cpu):
    lat = a1111.gs_noise_batch(message="hi", key_hex="44" * 32, nonce_hex="55" * 16,
                               seed=3, use_random_seed=True, device="cpu")
    assert tuple(lat.shape) == (4, 64, 64) and lat.dtype == torch.float32
    cfg = GSConfig(key_hex="44" * 32, nonce_hex="55" * 16, message_bits=256)
    _, acc = calculate_bit_accuracy((b"hi" + b"\x00" * 30).hex(), decode_latents(lat, cfg))
    assert acc == 1.0
    # use_repeat: 8-byte unit tiled x4
    lat2 = a1111.gs_noise_batch(message="watermrk", key_hex="44" * 32, nonce_hex="55" * 16,
                                use_repeat=True, device="cpu")
    _, acc2 = calculate_bit_accuracy((b"watermrk" * 4).hex(), decode_latents(lat2, cfg))
    assert acc2 == 1.0


@pytest.mark.parametrize("use_repeat", [False, True])
def test_a1111_noise_equals_jax_on_the_jax_draws(on_cpu, use_repeat):
    kw = dict(message="watermrk", key_hex="44" * 32, nonce_hex="55" * 16, seed=11,
              use_random_seed=True, use_repeat=use_repeat, width=512, height=384)
    want = ja1111.gs_noise_batch(**kw)
    got = a1111.gs_noise_batch(**kw, device="cpu", u=_jax_uniforms(11, want.size))
    assert tuple(got.shape) == want.shape == (4, 48, 64)
    np.testing.assert_array_equal(_bits_of(got), _bits_of(want))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=NDTRI_ATOL)


def _spec(name: str, package: bool = False):
    mod = types.ModuleType(name)
    mod.__spec__ = importlib.machinery.ModuleSpec(name, None, is_package=package)
    if package:
        mod.__path__ = []
    return mod


class _FailedRun(RuntimeError):
    pass


def _stub_webui(monkeypatch, generation: str, seen: list, fail: bool):
    """Stub ``gradio`` and ``modules.{scripts,shared,processing}`` (and
    ``modules.rng`` on >= 1.6.0).  ``process_images`` draws the first noise
    the way that generation does, records it, then raises if ``fail``."""
    gradio = _spec("gradio")
    for name in ("Textbox", "Number", "Checkbox"):
        setattr(gradio, name, lambda **kw: kw)
    modules = _spec("modules", package=True)
    scripts, shared, processing = (_spec(f"modules.{n}") for n in ("scripts", "shared",
                                                                     "processing"))
    scripts.Script = type("Script", (), {})
    shared.device = torch.device("cpu")
    shape = (4, 64, 64)

    def real_creator(shape, seeds, *a, **kw):
        return torch.zeros((len(seeds),) + tuple(shape))

    processing.create_random_tensors = real_creator
    rng = None
    if generation == "1.6.0":
        rng = _spec("modules.rng")

        class ImageRNG:
            def __init__(self, shape, seeds, **kw):
                self.shape = shape

            def first(self):
                return torch.zeros((1,) + tuple(self.shape))

            def next(self):
                return torch.ones((1,) + tuple(self.shape))

        rng.ImageRNG = ImageRNG

    def process_images(p):
        if rng is not None:
            gen = sys.modules["modules.rng"].ImageRNG(shape, [p.seed])
            seen.append((gen.next(), gen.next()))
        else:
            seen.append((sys.modules["modules.processing"].create_random_tensors(shape, [1]),))
        if fail:
            raise _FailedRun("the sampler failed")
        return "processed"

    processing.process_images = process_images
    modules.scripts, modules.shared, modules.processing = scripts, shared, processing
    stubs = {"gradio": gradio, "modules": modules, "modules.scripts": scripts,
             "modules.shared": shared, "modules.processing": processing}
    if rng is not None:
        modules.rng = rng
        stubs["modules.rng"] = rng
    for name, mod in stubs.items():
        monkeypatch.setitem(sys.modules, name, mod)
    return real_creator if rng is None else rng.ImageRNG


@pytest.mark.parametrize("fail", [False, True], ids=["returns", "raises"])
@pytest.mark.parametrize("generation", ["1.5.2", "1.6.0"])
@pytest.mark.parametrize("package", ["gswm_torch", "gswm"])
def test_make_script_patches_and_restores_the_real_object(on_cpu, monkeypatch, package,
                                                         generation, fail):
    """Both packages' scripts under a stub WebUI of each generation: the
    first noise is the watermark (decoding at 1.0), the next falls back to
    the WebUI's own (>= 1.6.0), and the real class or function is back in
    place after the run, also when ``process_images`` raises."""
    seen = []
    real = _stub_webui(monkeypatch, generation, seen, fail)
    mod = a1111 if package == "gswm_torch" else ja1111
    assert mod.Script is None  # imported without a WebUI
    if package == "gswm_torch":
        assert a1111.in_webui()
    script = mod._make_script()()
    assert len(script.ui(False)) == 6
    p = types.SimpleNamespace(width=512, height=512, seed=1)
    args = (p, "hi", "44" * 32, "55" * 16, 3, True, False)
    if fail:
        with pytest.raises(_FailedRun):
            script.run(*args)
    else:
        assert script.run(*args) == "processed"
    if generation == "1.6.0":
        assert sys.modules["modules.rng"].ImageRNG is real
        first, second = seen[0]
        assert torch.equal(second, torch.ones((1, 4, 64, 64)))
    else:
        assert sys.modules["modules.processing"].create_random_tensors is real
        (first,) = seen[0]
    cfg = GSConfig(key_hex="44" * 32, nonce_hex="55" * 16, message_bits=256)
    _, acc = calculate_bit_accuracy((b"hi" + b"\x00" * 30).hex(),
                                    decode_latents(torch.as_tensor(first[0]).float(), cfg))
    assert acc == 1.0


def test_no_webui_here():
    assert not a1111.in_webui() and a1111.Script is None


# -- the shims -----------------------------------------------------------------

def test_comfyui_shim_and_workflow_load_the_ports_node_keys():
    """The custom_nodes directory exports the port's node pair under keys of
    its own, none of them the JAX pack's; the example workflow is the JAX
    pack's graph on those keys."""
    from gswm_torch.integrations import comfyui_node

    assert comfyui_node.NODE_CLASS_MAPPINGS == {
        "Gswm_GSLatent_torch": comfyui.GSLatent,
        "Gswm_GS_KSamplerAdvanced_torch": comfyui.GSKSamplerAdvanced}
    assert not set(comfyui_node.NODE_CLASS_MAPPINGS) & set(jcomfy.NODE_CLASS_MAPPINGS)
    assert not (set(comfyui_node.NODE_DISPLAY_NAME_MAPPINGS.values())
                & set(jcomfy.NODE_DISPLAY_NAME_MAPPINGS.values()))
    ours = json.loads((PORT / "integrations/comfyui_node/example_workflows/"
                       "GS_insert_gswm_torch.json").read_text())
    theirs = json.loads((PORT.parent / "gswm/integrations/example_workflows/"
                         "GS_insert_gswm.json").read_text())
    assert ours["_meta"]["nodes_package"] == "gswm_torch.integrations.comfyui"
    gswm_nodes = [n["type"] for n in ours["nodes"] if n["type"].startswith("Gswm_")]
    assert sorted(gswm_nodes) == sorted(comfyui_node.NODE_CLASS_MAPPINGS)
    for a, b in zip(ours["nodes"], theirs["nodes"]):
        assert a["type"] in (b["type"], b["type"] + "_torch")
        inputs = dict(a["inputs"])
        if a["type"] == "SaveImage":
            inputs["filename_prefix"] = b["inputs"]["filename_prefix"]
        assert inputs == b["inputs"]
    # the node's inputs cover the workflow's GSLatent inputs
    latent = next(n for n in ours["nodes"] if n["type"] == "Gswm_GSLatent_torch")
    assert set(latent["inputs"]) == set(comfyui.GSLatent.INPUT_TYPES()["required"])
    pyproject = (PORT.parent / "pyproject.toml").read_text()
    assert '"gswm_torch.integrations" = ["comfyui_node/example_workflows/*.json"]' in pyproject


@pytest.mark.parametrize("name", ["GS_watermark_insert_for_webui.py",
                                  "GS_watermark_insert_for_webui_v1.5.2_and_lower.py",
                                  "GS_watermark_insert_for_webui_v1.6.0_and_higher.py"])
def test_webui_script_files_load_the_ports_script(name):
    ns = runpy.run_path(str(PORT / "integrations" / "scripts" / name))
    assert ns["Script"] is a1111.Script


def test_roundtrip_demo_on_the_cpu():
    """The demo end to end on the tiny preset (fit, embed, generate, device
    JPEG at 75, invert, vote): every image decodes above 0.9."""
    from gswm_torch.examples import roundtrip_demo

    scores = roundtrip_demo.main(["--device", "cpu"])
    assert len(scores) == 4
    assert all(acc >= 0.9 and p < 1e-5 for acc, p in scores), scores
