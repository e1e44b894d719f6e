"""The port's entry points run on the card unless the caller names another
device: ``device="cuda"`` is the default, and without a card the default
raises, as PyTorch does, instead of running on the CPU without a word."""

import dataclasses
import inspect

import pytest
import torch

from gswm_torch import GSConfig, embed_latents
from gswm_torch.core import chacha, embed, multikey
from gswm_torch.cli import gs_distort
from gswm_torch.eval import quality, trace
from gswm_torch.integrations import a1111, comfyui
from gswm_torch.models import clip
from gswm_torch.tools import run_robustness_sweep
from gswm_torch.utils import memory, profiling
from gswm_torch.treering import core as treering
from gswm_torch.pipelines import InversablePipeline

CFG = GSConfig(key_hex="22" * 32, nonce_hex="33" * 16, message="lthero",
               width=64, height=64, message_bits=32)


@pytest.mark.parametrize("fn", [
    InversablePipeline.__init__, embed.embed_latents, embed.encrypted_payload_bits,
    chacha.keystream_words, chacha.keystream_bits, chacha.keystream_words_reference,
    chacha.cached_keystream_bits, chacha.batch_keystream_bits,
    chacha.batch_keystream_bits_reference, multikey.embed_latents_multikey,
    trace.find_source_device, treering.get_watermarking_mask,
    treering.get_watermarking_pattern, gs_distort.process_images_in_directory,
    a1111.gs_noise_batch, quality.measure_similarity, quality.preprocess,
    clip.build_clip, profiling.stage, profiling.trace, memory.suggest_batch,
    memory.suggest_weights_dtype, memory.card_gib],
    ids=lambda fn: fn.__qualname__)
def test_entry_point_defaults_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")


def test_pipeline_without_device_raises_without_a_card(no_card):
    with pytest.raises((RuntimeError, AssertionError)):
        InversablePipeline("tiny")


def test_embed_without_device_raises_without_a_card(no_card):
    with pytest.raises((RuntimeError, AssertionError)):
        embed_latents(CFG)
    lat, _ = embed_latents(CFG, device="cpu")  # the CPU, asked for by name
    assert lat.device.type == "cpu"


def test_keystream_without_device_raises_without_a_card(no_card):
    with pytest.raises((RuntimeError, AssertionError)):
        chacha.keystream_bits(bytes(32), bytes(16), 64)
    assert chacha.keystream_bits(bytes(32), bytes(16), 64, "cpu").device.type == "cpu"


def test_multikey_and_trace_without_device_raise_without_a_card(no_card):
    keys, nonces = [bytes(32)], [bytes(16)]
    with pytest.raises((RuntimeError, AssertionError)):
        multikey.batch_keystream_bits(keys, nonces, 64)
    with pytest.raises((RuntimeError, AssertionError)):
        multikey.embed_latents_multikey(CFG, keys, nonces, [b"abcd"])
    record = {"key_hex": "00" * 32, "nonce_hex": "00" * 16, "message_hex": "00" * 4}
    with pytest.raises((RuntimeError, AssertionError)):
        trace.find_source_device(torch.zeros((4, 8, 8)), [record])
    assert multikey.batch_keystream_bits(keys, nonces, 64, "cpu").device.type == "cpu"


def test_bench_entry_points_without_device_raise_without_a_card(no_card, tmp_path):
    shape = (1, 4, 8, 8)
    with pytest.raises((RuntimeError, AssertionError)):
        treering.get_watermarking_mask(shape)
    with pytest.raises((RuntimeError, AssertionError)):
        treering.get_watermarking_pattern(shape)
    assert treering.get_watermarking_mask(shape, device="cpu").device.type == "cpu"
    assert treering.get_watermarking_pattern(shape, device="cpu").device.type == "cpu"
    with pytest.raises((RuntimeError, AssertionError)):  # --device defaults to cuda
        run_robustness_sweep.main(["--batch", "1", "--steps", "1", "--attacks", "none",
                                   "--out", str(tmp_path / "rows.jsonl")])
    assert not (tmp_path / "rows.jsonl").exists()


def test_distort_cli_without_device_raises_without_a_card(no_card, tmp_path):
    """The batched attacks are the CLI's default and run on the card: with no
    flag naming the CPU or the host it raises where there is none, for the
    reference's bare ``--device`` too."""
    import numpy as np
    from PIL import Image

    (tmp_path / "in").mkdir()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "in" / "a.png")
    flags = ["--input_dir", str(tmp_path / "in"), "--output_dir_base",
             str(tmp_path / "out"), "--distortion_type", "invert", "--strength", "0"]
    for more in ([], ["--device"]):
        with pytest.raises((RuntimeError, AssertionError)):
            gs_distort.main(flags + more)
    assert not list((tmp_path / "out").glob("*/*.png"))
    gs_distort.main(flags + ["--device", "cpu"])
    gs_distort.main(flags + ["--host"])
    assert len(list((tmp_path / "out").glob("*/a.png"))) == 1


class _NoAllocation:
    """Fail the test if anything is built while a refusal is due."""

    def __call__(self, *args, **kwargs):
        raise AssertionError("the pipeline built a module before refusing")


def _heads_of(width: int):
    """A test-local preset: sd-1-4 with self-attention heads ``width`` wide
    at every level (8, 16 and 32 heads, or 1, 2 and 4 at 520)."""
    from gswm_torch.models.configs import PRESETS

    sd14 = PRESETS["sd-1-4"]
    heads = 8 if width < 512 else 1
    channels = tuple(heads * width * m for m in (1, 2, 4, 4))
    unet = dataclasses.replace(sd14.unet, block_out_channels=channels, num_heads=None,
                               head_dim=width)
    return dataclasses.replace(sd14, name=f"sd-1-4, heads of {width}", unet=unet)


@pytest.mark.parametrize("preset,dtype,why", [
    # d % 8 != 0: rows of no tensor map; d > 512: no kernel template
    (36, torch.bfloat16, "heads 36 wide"),
    (520, torch.bfloat16, "heads 520 wide"),
    (36, torch.float32, "heads 36 wide"),
    ("sd-1-4", torch.float16, "torch.float16"),
    ("sd-2-1", torch.float16, "torch.float16"),
    ("sd-2-1-base", torch.float16, "torch.float16"),
    ("sdxl-base", torch.float16, "torch.float16")])
def test_pipeline_refuses_at_construction_what_the_card_does_not_serve(
        monkeypatch, preset, dtype, why):
    """Head dims outside the kernels' domain (d % 8 != 0 or d > 512), in
    either dtype, and float16 anywhere have no kernel: on a CUDA device the
    constructor says so, before it allocates anything there (so also on a
    machine without a card)."""
    from gswm_torch.pipelines import inversable

    if isinstance(preset, int):
        preset = _heads_of(preset)
    monkeypatch.setattr(inversable, "_build", _NoAllocation())
    with pytest.raises(NotImplementedError, match=why):
        InversablePipeline(preset, device=torch.device("cuda"), dtype=dtype,
                           generator=torch.Generator())
    with pytest.raises(NotImplementedError, match=why):
        InversablePipeline(preset, device="cuda:0", dtype=dtype)


@pytest.mark.parametrize("preset,dtype", [
    ("sd-2-1-base", torch.float32), ("sd-2-0-base", torch.float32),
    ("sd-2-1-base", torch.bfloat16), ("sd-1-4", torch.float32),
    ("sd-2-1", torch.float32), ("sd-2-0", torch.float32), ("sdxl-base", torch.float32)])
def test_pipeline_accepts_on_the_card_what_the_kernels_serve(monkeypatch, preset, dtype):
    """Every preset in float32 as in bfloat16: the float32 kernels take SD
    1.x's heads of 40, 80 and 160 and SD 2.x's and SDXL's 64, and the VAE's
    attention at d = 512 above 4096 tokens (sd-2-1 and sd-2-0 at 768x768,
    sdxl-base at 1024x1024): on a CUDA device the constructor passes the
    check and goes on to build its modules, which is stopped here before
    anything is allocated."""
    from gswm_torch.pipelines import inversable

    monkeypatch.setattr(inversable, "_build", _NoAllocation())
    with pytest.raises(AssertionError, match="built a module"):
        InversablePipeline(preset, device=torch.device("cuda"), dtype=dtype,
                           generator=torch.Generator())


def test_the_cpu_goes_on_running_what_the_card_refuses(monkeypatch):
    """float16 is not refused on the CPU (the constructor goes on to build
    its modules), nor are heads 36 wide; the tiny preset, whose attention
    stays below the kernels' window, passes the check for a CUDA device in
    any dtype; sd-1-4's heads of 40, 80 and 160 pass it in bfloat16 and
    float32."""
    from gswm_torch.models.configs import PRESETS
    from gswm_torch.models.unet import UNet2DCondition
    from gswm_torch.pipelines import inversable

    monkeypatch.setattr(inversable, "_build", _NoAllocation())
    with pytest.raises(AssertionError, match="built a module"):
        InversablePipeline("sd-1-4", device="cpu", dtype=torch.float16)
    with pytest.raises(AssertionError, match="built a module"):
        InversablePipeline(_heads_of(36), device="cpu", dtype=torch.float32)
    with torch.device("meta"):
        unet = UNet2DCondition(PRESETS["sd-1-4"].unet)
    assert [blk.attentions[0].transformer_blocks[0].attn1.head_dim
            for blk in unet.down_blocks[:3]] == [40, 80, 160]
    inversable._check_served_on_cuda(PRESETS["tiny"], torch.float32)
    inversable._check_served_on_cuda(PRESETS["tiny"], torch.float16)
    inversable._check_served_on_cuda(PRESETS["sd-1-4"], torch.float32)
    inversable._check_served_on_cuda(PRESETS["sd-2-1"], torch.bfloat16)
    inversable._check_served_on_cuda(PRESETS["sdxl-base"], torch.bfloat16)
    inversable._check_served_on_cuda(PRESETS["sd-1-4"], torch.bfloat16)


def test_host_surfaces_default_to_the_card():
    """The ComfyUI node embeds on ``GSLatent.device``; device_stats reads
    the card; the artifact tool, the anchors tool and the demo take
    ``--device`` / the card by default."""
    from gswm_torch.examples import roundtrip_demo
    from gswm_torch.tools import run_quality_artifact

    assert comfyui.GSLatent.device == "cuda"
    assert inspect.signature(profiling.device_stats).parameters["devices"].default == ("cuda",)
    for tool in (run_quality_artifact, roundtrip_demo):
        assert tool.build_parser().parse_args([]).device == "cuda"


def test_host_surfaces_without_device_raise_without_a_card(no_card, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises((RuntimeError, AssertionError)):
        comfyui.GSLatent().create_gs_latents(
            key="22" * 32, nonce="33" * 16, message="x", batch_size=1, use_seed=1,
            seed=1, width=64, height=64, message_length=32)
    with pytest.raises((RuntimeError, AssertionError)):
        a1111.gs_noise_batch("x", "44" * 32)
    assert a1111.gs_noise_batch("x", "44" * 32, device="cpu").device.type == "cpu"
    with pytest.raises((RuntimeError, AssertionError)):
        quality.preprocess(torch.zeros((1, 3, 8, 8)), {"do_resize": False,
                                                      "do_center_crop": False,
                                                      "do_normalize": False})
    with pytest.raises((RuntimeError, AssertionError)):
        clip.build_clip({"text_config": {"hidden_size": 8, "num_hidden_layers": 1,
                                         "num_attention_heads": 1},
                         "vision_config": {"hidden_size": 8, "num_hidden_layers": 1,
                                           "num_attention_heads": 1}})
    with pytest.raises((RuntimeError, AssertionError)):
        memory.suggest_batch(512)
    with pytest.raises((RuntimeError, AssertionError)):
        memory.suggest_weights_dtype(2**30)
    assert memory.suggest_batch(512, hbm_gb=80.0) > 8


def test_artifact_and_demo_without_device_raise_without_a_card(no_card, tmp_path):
    from gswm_torch.examples import roundtrip_demo
    from gswm_torch.tools import run_quality_artifact

    out = tmp_path / "rows.jsonl"
    with pytest.raises((RuntimeError, AssertionError)):
        run_quality_artifact.main(["--preset", "tiny", "--res", "32", "--batch", "2",
                                   "--steps", "1", "--out", str(out)])
    assert not out.exists()
    with pytest.raises((RuntimeError, AssertionError)):
        roundtrip_demo.main(["--steps", "1"])
