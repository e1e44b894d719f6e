"""PyTorch port vs the JAX package in bfloat16, the dtype of every run on the
card: the tiny preset built with ``dtype=jnp.bfloat16`` and
``dtype=torch.bfloat16`` on the CPU, the same bridged weights (norm scales
and biases drawn from a numpy seed, not 1 and 0), the same numpy inputs.

The two packages round to bf16 at different places (XLA fuses and keeps fp32
where ATen rounds between ops, and the other way round), so activations are
not equal.  Stated tolerances, measured first (UNet 2.3%, VAE encode 1.1%,
decode 1.0% of max |out|; recovered z_T 0.023):

  * UNet forward: max |diff| <= 5% of max |out| (a few bf16 steps of 2^-8
    relative, carried through the blocks);
  * VAE encode and decode: <= 3% of max |out|;
  * the latent closed loop (8 + 8 steps): recovered z_T within 0.1 of the
    JAX package's on N(0, 1) values, and EQUAL voted bits.

Norm parameters stay float32 under the bf16 compute dtype, as the JAX package
keeps them: held at the pipeline level (dtype and exact values after the
bridge) and at the layer level against the JAX layers.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gswm.config import GSConfig as JGSConfig
from gswm.core.decode import recover_message_bits as j_recover
from gswm.core.embed import embed_latents as j_embed
from gswm.models import layers as jlayers
from gswm.pipelines import InversablePipeline as JPipeline
from gswm_torch.config import GSConfig
from gswm_torch.core.decode import recover_message_bits
from gswm_torch.core.embed import embed_latents
from gswm_torch.models import layers
from gswm_torch.models.bridge import load_pipeline_params_
from gswm_torch.pipelines import InversablePipeline

torch.set_num_threads(2)

UNET_REL, VAE_REL, ZT_ABS = 0.05, 0.03, 0.1
STEPS = 8
BASE = dict(key_hex="22" * 32, nonce_hex="33" * 16, message="lthero",
            width=64, height=64, message_bits=32)


def _with_random_norms(tree, rng):
    """The flax tree with every norm's scale ~ 1 + 0.3 N(0, 1) and bias ~
    0.3 N(0, 1): values bf16 cannot hold."""
    out = {}
    for name, sub in tree.items():
        if hasattr(sub, "items"):
            sub = _with_random_norms(sub, rng)
            if "scale" in sub:
                shape = np.shape(sub["scale"])
                sub["scale"] = jnp.asarray(
                    (1 + 0.3 * rng.standard_normal(shape)).astype(np.float32))
                sub["bias"] = jnp.asarray(
                    (0.3 * rng.standard_normal(shape)).astype(np.float32))
        out[name] = sub
    return out


@pytest.fixture(scope="module")
def pipes():
    rng = np.random.default_rng(0)
    jpipe = JPipeline("tiny", dtype=jnp.bfloat16)
    jpipe.unet_params = _with_random_norms(dict(jpipe.unet_params), rng)
    jpipe.vae_params = _with_random_norms(dict(jpipe.vae_params), rng)
    pipe = InversablePipeline("tiny", device="cpu", dtype=torch.bfloat16)
    load_pipeline_params_(pipe, jpipe.unet_params, jpipe.vae_params,
                          jpipe.text_params)
    return jpipe, pipe


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max()


def test_norm_parameters_stay_float32_under_bf16(pipes):
    """Every GroupNorm and LayerNorm parameter of the UNet and the VAE is
    float32 after the constructor's cast and holds the bridged value
    exactly; every other parameter is bf16."""
    jpipe, pipe = pipes
    for model in (pipe.unet, pipe.vae):
        norm_params = set()
        for mod in model.modules():
            if isinstance(mod, (torch.nn.GroupNorm, torch.nn.LayerNorm)):
                assert isinstance(mod, (layers.GroupNorm32, layers.LayerNorm32))
                assert mod.weight.dtype == mod.bias.dtype == torch.float32
                norm_params |= {id(mod.weight), id(mod.bias)}
        assert norm_params
        others = [p for p in model.parameters() if id(p) not in norm_params]
        assert others and all(p.dtype == torch.bfloat16 for p in others)
    want = np.asarray(jpipe.unet_params["params"]["conv_norm_out"]["scale"])
    got = pipe.unet.conv_norm_out.weight.numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(
        got, torch.from_numpy(got).bfloat16().float().numpy())  # bf16 would round it
    block = pipe.unet.down_blocks[0].attentions[0].transformer_blocks[0]
    assert block.norm1.weight.dtype == torch.float32


@pytest.mark.parametrize("kind", ["group", "layer"])
def test_norm_layers_in_bf16_match_jax_with_float32_parameters(kind):
    """One norm on a bf16 input with float32 parameters bf16 cannot hold:
    the port's layer against the JAX package's (GroupNorm32, and flax's
    LayerNorm under dtype=bf16 as the transformer blocks build it) agrees to
    one bf16 step of the largest output, and is closer to it than the same
    layer with its parameters rounded to bf16 (the fault this pins)."""
    rng = np.random.default_rng(1)
    c = 64
    x = rng.standard_normal((2, 6, 6, c)).astype(np.float32)  # NHWC / (B, S, S, C)
    scale = (1 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(c)).astype(np.float32)
    params = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    if kind == "group":
        jmod = jlayers.GroupNorm32(8, epsilon=1e-5)
        mod = layers.GroupNorm32(8, c, eps=1e-5)
        xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).bfloat16()
        back = lambda y: y.permute(0, 2, 3, 1)
    else:
        jmod = nn.LayerNorm(epsilon=1e-5, dtype=jnp.bfloat16)
        mod = layers.LayerNorm32(c, eps=1e-5)
        xt = torch.from_numpy(x).bfloat16()
        back = lambda y: y
    want = np.asarray(jmod.apply(params, xb), np.float32)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(scale))
        mod.bias.copy_(torch.from_numpy(bias))
        layers.to_compute_dtype_(mod, "cpu", torch.bfloat16)
        got = back(mod(xt)).float().numpy()
        rounded = back(mod.to(torch.bfloat16)(xt)).float().numpy()
    assert got.shape == want.shape
    step = 2.0 ** -7 * np.abs(want).max()  # one bf16 step at the largest output
    assert np.abs(got - want).max() <= step
    assert np.abs(got - want).mean() < np.abs(rounded - want).mean()


def test_unet_forward_bf16(pipes):
    jpipe, pipe = pipes
    rng = np.random.default_rng(2)
    lat = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    t = np.array([10, 501], np.int32)
    ctx = np.array(jpipe.empty_context(2))
    want = jax.jit(jpipe.unet.apply)(jpipe.unet_params, lat, t, ctx)
    with torch.no_grad():
        got = pipe.unet(torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(ctx))
    assert got.shape == (2, 4, 8, 8) and torch.isfinite(got).all()
    assert _rel(got.float().numpy(), want) <= UNET_REL


def test_vae_encode_and_decode_bf16(pipes):
    jpipe, pipe = pipes
    rng = np.random.default_rng(3)
    img = rng.random((2, 3, 16, 16), dtype=np.float32)
    want = jpipe.image_to_latents(jnp.asarray(img))
    got = pipe.image_to_latents(torch.from_numpy(img))
    assert got.shape == (2, 4, 8, 8) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= VAE_REL
    z = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    want = jpipe.decode_image(jnp.asarray(z))
    got = pipe.decode_image(torch.from_numpy(z))
    assert got.shape == (2, 3, 16, 16)
    assert _rel(got.numpy(), want) <= VAE_REL


def test_closed_loop_bits_equal_jax_in_bf16(pipes):
    """embed(u) -> 8-step generate -> 8-step inversion -> decode, both in
    bf16: equal voted bits, which are the message."""
    jpipe, pipe = pipes
    cfg, jcfg = GSConfig(**BASE), JGSConfig(**BASE)
    u = np.random.default_rng(5).random((2, cfg.total_elements), dtype=np.float32)
    zt, msg = embed_latents(cfg, batch=2, u=u, device="cpu")
    jzt, _ = j_embed(jcfg, batch=2, u=jnp.asarray(u))
    z_back = pipe.invert(latents=pipe.generate(zt, guidance_scale=1.0, num_steps=STEPS,
                                               decode=False), num_steps=STEPS)
    jz_back = jpipe.invert(latents=jpipe.generate(jzt, guidance_scale=1.0,
                                                  num_steps=STEPS, decode=False),
                           num_steps=STEPS)
    assert z_back.dtype == torch.float32
    assert np.abs(z_back.numpy() - np.asarray(jz_back)).max() <= ZT_ABS
    bits = recover_message_bits(z_back, cfg).numpy()
    np.testing.assert_array_equal(bits, np.asarray(j_recover(jz_back, jcfg)))
    want = np.unpackbits(np.frombuffer(msg, np.uint8))
    assert (bits == want).all()
