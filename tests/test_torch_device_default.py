"""The port's entry points run on the card unless the caller names another
device: ``device="cuda"`` is the default, and without a card the default
raises, as PyTorch does, instead of running on the CPU without a word."""

import inspect

import pytest
import torch

from gswm_torch import GSConfig, embed_latents
from gswm_torch.core import chacha, embed, multikey
from gswm_torch.cli import gs_distort
from gswm_torch.eval import trace
from gswm_torch.tools import run_robustness_sweep
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
    treering.get_watermarking_pattern, gs_distort.process_images_in_directory],
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


@pytest.mark.parametrize("preset,dtype,why", [
    ("sd-1-4", torch.bfloat16, "heads are"),
    ("sd-2-1-base", torch.float32, "bfloat16 only"),
    ("sd-2-1", torch.float16, "bfloat16 only"),
    ("sdxl-base", torch.float32, "bfloat16 only")])
def test_pipeline_refuses_at_construction_what_the_card_does_not_serve(
        monkeypatch, preset, dtype, why):
    """SD 1.x head dims (40, 80, 160) and any dtype but bfloat16 have no
    kernel: on a CUDA device the constructor says so, before it allocates
    anything there (so also on a machine without a card); SDXL likewise."""
    from gswm_torch.pipelines import inversable

    monkeypatch.setattr(inversable, "_build", _NoAllocation())
    with pytest.raises(NotImplementedError, match=why):
        InversablePipeline(preset, device=torch.device("cuda"), dtype=dtype,
                           generator=torch.Generator())
    with pytest.raises(NotImplementedError, match=why):
        InversablePipeline(preset, device="cuda:0", dtype=dtype)


def test_the_cpu_goes_on_running_what_the_card_refuses(monkeypatch):
    """sd-1-4 in float32 is not refused on the CPU (the constructor goes on
    to build its modules), and the tiny preset, whose attention stays below
    the kernels' window, passes the check for a CUDA device in any dtype."""
    from gswm_torch.models.configs import PRESETS
    from gswm_torch.models.unet import UNet2DCondition
    from gswm_torch.pipelines import inversable

    monkeypatch.setattr(inversable, "_build", _NoAllocation())
    with pytest.raises(AssertionError, match="built a module"):
        InversablePipeline("sd-1-4", device="cpu", dtype=torch.float32)
    with torch.device("meta"):
        unet = UNet2DCondition(PRESETS["sd-1-4"].unet)
    assert [blk.attentions[0].transformer_blocks[0].attn1.head_dim
            for blk in unet.down_blocks[:3]] == [40, 80, 160]
    inversable._check_served_on_cuda(PRESETS["tiny"], torch.float32)
    inversable._check_served_on_cuda(PRESETS["sd-2-1"], torch.bfloat16)
    inversable._check_served_on_cuda(PRESETS["sdxl-base"], torch.bfloat16)
