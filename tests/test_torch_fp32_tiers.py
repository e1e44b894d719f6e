"""The attention tiers off the default route in float32, the port against the
JAX package on the CPU: the narrowed sd-2-1-base UNet under switch sets (b)
(the pair-packed tier, K6) and (c) (the transposed tier, K7).

The model is tests/test_torch_fp32.py's: sd-2-1-base cut in width where the
route is concerned (heads of 64, 1, 2 and 4 of them; channels 64, 128,
256, 256), 32x32 latents.  The reference's own windows
(``GSWM_PACKED_ATTN_MIN_SEQ``, ``GSWM_TRANSPOSED_ATTN_MIN_SEQ``) open at 256
tokens, so levels 0 and 1 (1024 and 256 tokens) take the tier in both
packages: the JAX one its Pallas kernel in interpret mode
(``GSWM_FORCE_FLASH=1``), at a batch of 8 under (c), which its transposed
tier needs (8-sublane DMA); the port its wrapper, whose plain version runs
here and whose float32 kernel (csrc/flash_f32.cu) is held to that plain
version on the card.  The JAX transposed kernel drops the running max and
clamps its logits at 60 (a pinned divergence: the port keeps the exact
softmax), so the test checks that every logit stays below 60.

Within 2e-5 of max |out| (``UNET_REL`` of tests/test_torch_fp32.py: two fp32
computations of one function, sums in other orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gswm.ops.attention as jattn
from gswm.models import configs as jconfigs
from gswm.pipelines import InversablePipeline as JPipeline
from gswm_torch.models import configs, layers
from gswm_torch.models.bridge import load_pipeline_params_
from gswm_torch.ops import attention as attn
from gswm_torch.pipelines import InversablePipeline
from gswm_torch.tools.paths import TIER_SWITCHES

torch.set_num_threads(2)

UNET_REL = 2e-5
# the tiers' windows opened to level 1's 256 tokens, by the reference's own
# switches
WINDOWS = {"b": {"GSWM_PACKED_ATTN_MIN_SEQ": "256"},
           "c": {"GSWM_TRANSPOSED_ATTN_MIN_SEQ": "256"}}
# (the JAX package's kernel, the port's wrapper, the batch both take it at)
TIERS = {"b": ("flash_attention_packed", "flash_attention_packed", 2),
         "c": ("flash_attention_transposed", "flash_attention_transposed", 8)}


def _narrowed(c):
    """sd-2-1-base cut in width alone where the route is concerned (as
    tests/test_torch_fp32.py's): heads of 64 at every level, a 32-wide text
    encoder of two layers and the tiny VAE; 32x32 latents."""
    base = c.SD_2_1_BASE
    unet = dataclasses.replace(base.unet, block_out_channels=(64, 128, 256, 256),
                               cross_attn_dim=32)
    text = dataclasses.replace(base.text, vocab_size=1000, hidden_size=32, num_layers=2,
                               num_heads=2)
    return dataclasses.replace(base, name="sd-2-1-base, narrowed", unet=unet,
                               vae=c.TINY.vae, text=text, default_resolution=256)


@pytest.fixture(scope="module")
def pipes():
    jpipe = JPipeline(_narrowed(jconfigs), dtype=jnp.float32)
    pipe = InversablePipeline(_narrowed(configs), device="cpu", dtype=torch.float32)
    load_pipeline_params_(pipe, jpipe.unet_params, jpipe.vae_params, jpipe.text_params)
    return jpipe, pipe


def _max_logit(name: str, qkv: torch.Tensor, heads: int = 0) -> float:
    """The largest |q k^T d^-0.5| of one call of the port's wrapper (the
    packed layout's heads are 64 wide; the transposed one's ``heads``)."""
    if name == "flash_attention_packed":
        b, s, c3 = qkv.shape
        q, k, _ = (t.reshape(b, s, -1, 64) for t in qkv.split(c3 // 3, dim=-1))
    else:
        _, b, s = qkv.shape
        q, k, _ = qkv.reshape(3, heads, -1, b, s).permute(0, 3, 4, 1, 2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    return logits.abs().max().item()


@pytest.mark.parametrize("switch_set", ["b", "c"])
def test_narrowed_sd21_base_unet_under_switch_set_matches_jax_in_fp32(pipes, monkeypatch,
                                                                    switch_set):
    """One UNet forward, fp32: under (b) both packages take the pair-packed
    tier at levels 0 and 1 (5 + 5 sites), under (c) the transposed tier;
    level 2's 64 tokens stay plain in both.  The port's calls by wrapper,
    none of its other wrappers, and within UNET_REL of the JAX UNet."""
    jpipe, pipe = pipes
    for name, value in {**TIER_SWITCHES[switch_set], **WINDOWS[switch_set]}.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setenv("GSWM_FORCE_FLASH", "1")
    jname, wrapper, b = TIERS[switch_set]
    rng = np.random.default_rng(84)
    lat = rng.standard_normal((b, 4, 32, 32)).astype(np.float32)
    t = np.array([10, 501, 260, 999, 0, 750, 125, 400][:b], np.int32)
    ctx = rng.standard_normal((b, 77, 32)).astype(np.float32)
    kernel, jcalls = getattr(jattn, jname), []

    def jtier(qkv, *args, **kwargs):
        jcalls.append(qkv.shape)
        return kernel(qkv, *args, **kwargs)

    monkeypatch.setattr(jattn, jname, jtier)
    want = np.asarray(jax.jit(lambda *a: jpipe.unet.apply(*a))(jpipe.unet_params, lat, t, ctx))
    assert len(jcalls) == 10  # traced once a site
    calls, logits = [], []

    def record(name):
        real = getattr(layers, name)

        def call(x, *args):
            calls.append(name)
            if name == wrapper:
                logits.append(_max_logit(name, x, *args))
            return real(x, *args)
        monkeypatch.setattr(layers, name, call)

    for name in ("flash_attention_packed", "flash_attention_transposed", "fused_qkv_attention",
                 "flash_attention", "flash_attention_split"):
        record(name)
    with torch.inference_mode():
        got = pipe.unet(*(torch.from_numpy(a) for a in (lat, t, ctx)))
    assert calls == [wrapper] * 10
    assert max(logits) < 60
    assert got.dtype == torch.float32 and got.shape == (b, 4, 32, 32)
    assert np.abs(got.numpy() - want).max() <= UNET_REL * np.abs(want).max()


@pytest.mark.parametrize("switch_set", ["b", "c"])
def test_switch_sets_route_the_narrowed_levels_to_their_tier(monkeypatch, switch_set):
    """The port's route at the narrowed model's sites: levels 0 and 1 (1024
    and 256 tokens, heads of 64) take the tier, level 2 (64) and the mid
    block (16) stay plain; what ``dtype_kernel`` names for them in float32
    is csrc/flash_f32.cu's kernel of that layout."""
    for name, value in {**TIER_SWITCHES[switch_set], **WINDOWS[switch_set]}.items():
        monkeypatch.setenv(name, value)
    tier = {"b": "packed", "c": "transposed"}[switch_set]
    assert [attn.route_self_attention(s, 64) for s in (1024, 256, 64, 16)] == \
        [tier, tier, "plain", "plain"]
    layout = attn.PACKED if tier == "packed" else "transposed"
    assert attn.dtype_kernel(torch.float32, 64, layout) == (
        "flash_f32_kernel<1, 64>" if tier == "packed" else "flash_f32_kernel<1, 64, transposed>")
