"""The port's entry points run on the card unless the caller names another
device: ``device="cuda"`` is the default, and without a card the default
raises, as PyTorch does, instead of running on the CPU without a word."""

import inspect

import pytest
import torch

from gswm_torch import GSConfig, embed_latents
from gswm_torch.core import chacha, embed
from gswm_torch.pipelines import InversablePipeline

CFG = GSConfig(key_hex="22" * 32, nonce_hex="33" * 16, message="lthero",
               width=64, height=64, message_bits=32)


@pytest.mark.parametrize("fn", [
    InversablePipeline.__init__, embed.embed_latents, embed.encrypted_payload_bits,
    chacha.keystream_words, chacha.keystream_bits, chacha.keystream_words_reference],
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
