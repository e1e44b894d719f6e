"""PyTorch port vs the JAX package: model modules in fp32 on the CPU.

Weights come from the JAX modules' own ``init`` and cross through
``gswm_torch.models.bridge``; inputs are numpy draws.  Tolerance: relative
1e-4 with an absolute floor of 1e-5 (fp32, different reduction orders —
GroupNorm's variance form and XLA's vs ATen's conv/matmul accumulation).
The JAX side uses NHWC inside its layers; module-level comparisons transpose
at the boundary, the model-level ones take NCHW on both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gswm.models import layers as jlayers
from gswm.models.configs import TINY
from gswm.models.text import TextEncoder as JTextEncoder
from gswm.models.unet import UNet2DCondition as JUNet
from gswm.models.vae import AutoencoderKL as JVAE
from gswm_torch.models import bridge
from gswm_torch.models import layers
from gswm_torch.models.text import TextEncoder
from gswm_torch.models.unet import UNet2DCondition
from gswm_torch.models.vae import AutoencoderKL

torch.set_num_threads(2)
RTOL, ATOL = 1e-4, 1e-5


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("vae", [False, True], ids=["unet", "vae"])
def test_resnet_block(vae):
    x = _rand((2, 8, 8, 16), 0)
    temb = None if vae else _rand((2, 64), 1)
    jmod = jlayers.ResnetBlock(32, norm_groups=8, use_time_emb=not vae,
                               norm_eps=1e-6 if vae else 1e-5)
    params = jmod.init(jax.random.key(0), x, temb)
    want = np.asarray(jmod.apply(params, x, temb)).transpose(0, 3, 1, 2)
    mod = layers.ResnetBlock(16, 32, 8, temb_dim=None if vae else 64,
                             norm_eps=1e-6 if vae else 1e-5)
    bridge.load_tree_(mod, params)
    _close(mod(_nchw(x), None if vae else torch.from_numpy(temb)), want)


@pytest.mark.parametrize("hw,linear,heads,head_dim", [
    (8, False, 2, 64), (16, True, 2, 64), (49, True, 2, 64),
    # SD 1.x: 8 heads of 40 and of 80, conv proj_in
    (16, False, 8, 40), (49, False, 8, 40), (16, False, 8, 80), (49, False, 8, 80)],
    ids=["plain-conv", "fused-qkv-route", "flash-route", "sd14-d40-fused-qkv-route",
         "sd14-d40-flash-route", "sd14-d80-fused-qkv-route", "sd14-d80-flash-route"])
def test_transformer2d(hw, linear, heads, head_dim):
    """Tokens 64 / 256 / 2401 take the plain, fused-qkv and flash routes."""
    c = heads * head_dim
    x = _rand((1, hw, hw, c), 2)
    ctx = _rand((1, 77, 32), 3)
    jmod = jlayers.Transformer2D(heads=heads, head_dim=head_dim, depth=1,
                                 use_linear_projection=linear, norm_groups=8)
    params = jmod.init(jax.random.key(1), x, ctx)
    want = np.asarray(jax.jit(jmod.apply)(params, x, ctx)).transpose(0, 3, 1, 2)
    mod = layers.Transformer2D(c, heads, head_dim, 32, depth=1,
                               use_linear_projection=linear, norm_groups=8)
    bridge.load_tree_(mod, params)
    with torch.no_grad():
        _close(mod(_nchw(x), torch.from_numpy(ctx)), want)


def test_timestep_embedding():
    t = np.array([1, 10, 500, 999], np.int32)
    for dim, flip, shift in ((32, True, 0), (33, False, 1)):
        want = jlayers.timestep_embedding(jnp.asarray(t), dim, flip, shift)
        got = layers.timestep_embedding(torch.from_numpy(t), dim, flip, shift)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("sd2", [False, True], ids=["tiny", "tiny-sd2-heads"])
def test_unet(sd2):
    cfg = TINY.unet
    if sd2:  # SD 2.x head policy: fixed head_dim, linear projections
        cfg = dataclasses.replace(cfg, num_heads=None, head_dim=16,
                                  use_linear_projection=True)
    jmod = JUNet(cfg)
    params = jmod.init_params(jax.random.key(2))
    lat = _rand((2, 4, 8, 8), 4)
    t = np.array([10, 501], np.int32)
    ctx = _rand((2, 77, 32), 5)
    want = jax.jit(jmod.apply)(params, lat, t, ctx)
    mod = UNet2DCondition(cfg)
    bridge.load_tree_(mod, params)
    with torch.no_grad():
        got = mod(torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(ctx))
    assert got.dtype == torch.float32 and got.shape == (2, 4, 8, 8)
    _close(got, want)


def test_vae_encoder():
    jmod = JVAE(TINY.vae)
    params = jmod.init(jax.random.key(3), jnp.zeros((1, 3, 16, 16)))
    img = np.random.default_rng(6).random((2, 3, 16, 16), dtype=np.float32) * 2 - 1
    mean, logvar = jax.jit(lambda p, x: jmod.apply(
        p, x, method=JVAE.encode_moments))(params, img)
    mod = AutoencoderKL(TINY.vae)
    bridge.load_tree_(mod, params)
    with torch.no_grad():
        got_mean, got_logvar = mod.encode_moments(torch.from_numpy(img))
        _close(got_mean, mean)
        _close(got_logvar, logvar)
        _close(mod.encode(torch.from_numpy(img)), np.asarray(mean) * 0.18215)


def test_vae_decoder():
    """The tiny VAE decoder on bridged weights against JAX decode."""
    jmod = JVAE(TINY.vae)
    params = jmod.init(jax.random.key(4), jnp.zeros((1, 3, 16, 16)))
    lat = _rand((2, 4, 8, 8), 7)
    want = jax.jit(lambda p, z: jmod.apply(p, z, method=JVAE.decode))(params, lat)
    mod = AutoencoderKL(TINY.vae)
    bridge.load_tree_(mod, params)
    with torch.no_grad():
        got = mod.decode(torch.from_numpy(lat))
    assert got.dtype == torch.float32 and got.shape == (2, 3, 16, 16)
    _close(got, want)


def test_vae_attention_split_route(monkeypatch):
    """Above the token threshold (patched to 512; 32x32 = 1024 tokens) the
    port's VAEAttention takes ``flash_attention_split`` with one head of
    d = C, as the JAX module takes its Pallas flash kernel (GSWM_FORCE_FLASH,
    tests/test_ops_attention.py:91-104); fp32, atol/rtol 3e-5."""
    x = _rand((1, 32, 32, 64), 8)
    jmod = jlayers.VAEAttention(dtype=jnp.float32)
    params = jmod.init(jax.random.key(9), x)
    monkeypatch.setenv("GSWM_FORCE_FLASH", "1")
    monkeypatch.setattr(jlayers, "_VAE_FLASH_MIN_TOKENS", 512)
    want = np.asarray(jmod.apply(params, x)).transpose(0, 3, 1, 2)

    calls = []
    real_split = layers.flash_attention_split

    def split(q, k, v):
        calls.append(tuple(q.shape))
        return real_split(q, k, v)

    monkeypatch.setattr(layers, "VAE_FLASH_MIN_TOKENS", 512)
    monkeypatch.setattr(layers, "flash_attention_split", split)
    mod = layers.VAEAttention(64)
    bridge.load_tree_(mod, params)
    with torch.no_grad():
        got = mod(_nchw(x))
    assert calls == [(1, 1024, 1, 64)]
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("act,penultimate", [("quick_gelu", False), ("gelu", True)])
def test_clip_text_encoder(act, penultimate):
    cfg = dataclasses.replace(TINY.text, hidden_act=act, penultimate=penultimate)
    jenc = JTextEncoder(cfg)
    ids = jenc.empty_prompt_ids(2)
    ids[1, 1:6] = [5, 17, 300, 2, 999]
    want = jenc(jnp.asarray(ids))
    enc = TextEncoder(cfg)
    bridge.load_tree_(enc, jenc.params)
    np.testing.assert_array_equal(enc.empty_prompt_ids(2), jenc.empty_prompt_ids(2))
    with torch.no_grad():
        _close(enc(ids), want)


def test_bridge_raises_on_leftover_keys():
    x = _rand((1, 4, 4, 16), 0)
    jmod = jlayers.ResnetBlock(16, norm_groups=8, use_time_emb=False)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.key(0), x))["params"]
    bridge.load_tree_(layers.ResnetBlock(16, 16, 8), params)

    extra = dict(params, conv_shortcut={"kernel": np.zeros((1, 1, 16, 16)),
                                        "bias": np.zeros(16)})
    with pytest.raises(ValueError, match="unexpected"):
        bridge.load_tree_(layers.ResnetBlock(16, 16, 8), extra)
    missing = {k: v for k, v in params.items() if k != "norm2"}
    with pytest.raises(ValueError, match="missing"):
        bridge.load_tree_(layers.ResnetBlock(16, 16, 8), missing)
    with pytest.raises(ValueError, match="shape"):
        bridge.load_tree_(layers.ResnetBlock(16, 16, 8, temb_dim=None), dict(
            params, conv1={"kernel": np.zeros((3, 3, 16, 8)), "bias": np.zeros(16)}))


def test_bridge_names_follow_diffusers():
    """The converted names are diffusers' state-dict names."""
    tree = {"down_blocks_0": {"attentions_1": {"transformer_blocks_0": {
        "attn1": {"to_out": {"kernel": np.zeros((4, 3)), "bias": np.zeros(3)}},
        "ff": {"net_0": {"proj": {"kernel": np.zeros((4, 6))}},
               "net_2": {"kernel": np.zeros((6, 4))}}}}},
        "conv_in": {"kernel": np.zeros((3, 3, 4, 8))},
        "conv_norm_out": {"scale": np.ones(8)}}
    sd = bridge.convert_tree(tree)
    assert sorted(sd) == sorted([
        "down_blocks.0.attentions.1.transformer_blocks.0.attn1.to_out.0.weight",
        "down_blocks.0.attentions.1.transformer_blocks.0.attn1.to_out.0.bias",
        "down_blocks.0.attentions.1.transformer_blocks.0.ff.net.0.proj.weight",
        "down_blocks.0.attentions.1.transformer_blocks.0.ff.net.2.weight",
        "conv_in.weight", "conv_norm_out.weight"])
    assert sd["conv_in.weight"].shape == (8, 4, 3, 3)
    assert sd["down_blocks.0.attentions.1.transformer_blocks.0.ff.net.2.weight"] \
        .shape == (4, 6)


@pytest.mark.parametrize("edit", ["missing", "extra"])
def test_bridge_loads_the_whole_vae_and_raises_on_decoder_keys(edit):
    """The whole JAX VAE tree loads, decoder included; a decoder key left
    over on either side raises."""
    jmod = JVAE(TINY.vae)
    params = jax.tree.map(np.asarray, jmod.init(
        jax.random.key(3), jnp.zeros((1, 3, 16, 16))))["params"]
    bridge.load_tree_(AutoencoderKL(TINY.vae), params)
    dec = dict(params["decoder"])
    if edit == "missing":
        dec.pop("conv_norm_out")
    else:
        dec["conv_extra"] = {"kernel": np.zeros((3, 3, 16, 16)), "bias": np.zeros(16)}
    with pytest.raises(ValueError, match="unexpected" if edit == "extra" else "missing"):
        bridge.load_tree_(AutoencoderKL(TINY.vae), dict(params, decoder=dec))
