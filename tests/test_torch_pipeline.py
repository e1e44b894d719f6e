"""PyTorch port vs the JAX package: the tiny-preset pipeline.

The JAX ``InversablePipeline("tiny", dtype=float32)`` is built once per
module (its construction is the slow part); the port's pipeline gets its
weights through ``gswm_torch.models.bridge``.  Both run the same chains on
the same numpy inputs: embed(u) -> 8-step generate (DDIM or DPM++, with or
without guidance and the VAE decoder) -> 8-step inversion -> decode.  The
voted bits must be equal; latents, z_T and images agree to rtol 1e-3 /
atol 1e-4 (the two frameworks accumulate convolutions and matmuls in
different orders, and the difference compounds over 16 UNet evaluations).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gswm.config import GSConfig as JGSConfig
from gswm.core.decode import recover_message_bits as j_recover
from gswm.core.embed import embed_latents as j_embed
from gswm.models.configs import TINY as J_TINY
from gswm.pipelines import InversablePipeline as JPipeline
from gswm_torch.config import GSConfig
from gswm_torch.core.decode import recover_message_bits
from gswm_torch.core.embed import embed_latents
from gswm_torch.models.bridge import load_pipeline_params_
from gswm_torch.models.configs import TINY
from gswm_torch.pipelines import InversablePipeline
from gswm_torch.pipelines.inversable import PipelineOutput

torch.set_num_threads(2)

STEPS = 8
BASE = dict(key_hex="22" * 32, nonce_hex="33" * 16, message="lthero",
            width=64, height=64, message_bits=32)


@pytest.fixture(scope="module")
def pipes():
    jpipe = JPipeline("tiny", dtype=jnp.float32)
    pipe = InversablePipeline("tiny", device="cpu", dtype=torch.float32)
    load_pipeline_params_(pipe, jpipe.unet_params, jpipe.vae_params,
                          jpipe.text_params)
    return jpipe, pipe


def test_empty_context_matches(pipes):
    jpipe, pipe = pipes
    want = np.asarray(jpipe.empty_context(2))
    got = pipe.empty_context(2)
    assert got.shape == want.shape == (2, 77, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_closed_loop_bits_equal_jax(pipes):
    """embed(u) -> generate -> invert -> decode: equal voted bits."""
    jpipe, pipe = pipes
    cfg, jcfg = GSConfig(**BASE), JGSConfig(**BASE)
    u = np.random.default_rng(5).random((2, cfg.total_elements), dtype=np.float32)
    zt, msg = embed_latents(cfg, batch=2, u=u, device="cpu")
    jzt, jmsg = j_embed(jcfg, batch=2, u=jnp.asarray(u))
    assert msg == jmsg

    x0 = pipe.generate(zt, guidance_scale=1.0, num_steps=STEPS, decode=False)
    jx0 = jpipe.generate(jzt, guidance_scale=1.0, num_steps=STEPS, decode=False)
    np.testing.assert_allclose(x0.numpy(), np.asarray(jx0), rtol=1e-3, atol=1e-4)

    z_back = pipe.invert(latents=x0, num_steps=STEPS)
    jz_back = jpipe.invert(latents=jx0, num_steps=STEPS)
    np.testing.assert_allclose(z_back.numpy(), np.asarray(jz_back), rtol=1e-3,
                               atol=1e-4)

    bits = recover_message_bits(z_back, cfg).numpy()
    jbits = np.asarray(j_recover(jz_back, jcfg))
    np.testing.assert_array_equal(bits, jbits)
    want = np.unpackbits(np.frombuffer(msg, np.uint8))
    assert (bits == want).all()


def test_image_to_latents_matches_jax(pipes):
    jpipe, pipe = pipes
    img = np.random.default_rng(9).random((3, 3, 16, 16), dtype=np.float32)
    want = np.asarray(jpipe.image_to_latents(jnp.asarray(img)))
    got = pipe.image_to_latents(torch.from_numpy(img))
    assert got.shape == want.shape == (3, 4, 8, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_extract_bits_is_invert_plus_decode(pipes):
    """Image in: VAE encode -> inversion -> decode in one call, equal to the
    split path and to the JAX package's fused extraction."""
    jpipe, pipe = pipes
    kw = dict(BASE, width=16, height=16, vae_scale=2)
    cfg, jcfg = GSConfig(**kw), JGSConfig(**kw)
    img = np.random.default_rng(11).random((2, 3, 16, 16), dtype=np.float32)
    bits, z_t = pipe.extract_bits(cfg, images=torch.from_numpy(img), num_steps=4)
    z_split = pipe.invert(images=torch.from_numpy(img), num_steps=4)
    torch.testing.assert_close(z_t, z_split, rtol=0, atol=0)
    assert torch.equal(bits, recover_message_bits(z_split, cfg))
    jbits, jz = jpipe.extract_bits(jcfg, images=jnp.asarray(img), num_steps=4)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(jz), rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    assert bits.shape == (2, 32) and bits.dtype == torch.uint8


def test_unported_options_raise():
    """SDXL is ported: sdxl-base builds on the meta device (nothing
    allocated) with both text encoders at full size; SD 1.x passes the CUDA
    check in bfloat16 and builds on the meta device; what is still refused
    (other dtypes, head dims off the kernels' domain) is refused on a CUDA
    device (tests/test_torch_device_default.py)."""
    pipe = InversablePipeline("sdxl-base", device="meta")
    assert pipe.text2 is not None and pipe.text2_projection is None
    assert sum(p.numel() for p in pipe.unet.parameters()) == 2_567_463_684
    assert pipe.unet.conv_in.weight.dtype == torch.bfloat16
    assert pipe.text2.text_model.final_layer_norm.weight.device.type == "meta"
    sd14 = InversablePipeline("sd-1-4", device="meta")
    assert sd14.unet.conv_in.weight.dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="bfloat16 only"):
        InversablePipeline("sd-1-4", device="cuda", dtype=torch.float32)


def _embedded(seed=5):
    cfg, jcfg = GSConfig(**BASE), JGSConfig(**BASE)
    u = np.random.default_rng(seed).random((2, cfg.total_elements), dtype=np.float32)
    zt, msg = embed_latents(cfg, batch=2, u=u, device="cpu")
    jzt, _ = j_embed(jcfg, batch=2, u=jnp.asarray(u))
    return cfg, jcfg, zt, jzt, msg


@pytest.fixture(scope="module")
def generated(pipes):
    """Prompt token ids -> 8-step DDIM at guidance 7.5 -> VAE decode, on
    both sides."""
    jpipe, pipe = pipes
    _, _, zt, jzt, _ = _embedded()
    ids = np.random.default_rng(21).integers(0, TINY.text.vocab_size, (2, 77))
    out = pipe.generate_with_init(zt, prompt_ids=ids, guidance_scale=7.5,
                                  num_steps=STEPS)
    jimages = jpipe.generate(jzt, prompt_ids=jnp.asarray(ids), guidance_scale=7.5,
                             num_steps=STEPS)
    return out, zt, np.asarray(jimages)


def test_generate_guided_decoded_matches_jax(generated):
    out, zt, jimages = generated
    assert isinstance(out, PipelineOutput)
    assert out.nsfw_content_detected == [False, False]
    assert torch.equal(out.init_latents, zt)
    images = out.images
    assert images.shape == jimages.shape == (2, 3, 16, 16)
    assert images.dtype == torch.float32
    assert 0.0 <= images.min().item() and images.max().item() <= 1.0
    np.testing.assert_allclose(images.numpy(), jimages, rtol=1e-3, atol=1e-4)


def test_extract_bits_from_generated_images_equal_jax(pipes, generated):
    """The generated images through VAE encode -> inversion -> decode on
    both sides: equal voted bits."""
    jpipe, pipe = pipes
    out, _, _ = generated
    cfg, jcfg = GSConfig(**BASE), JGSConfig(**BASE)
    bits, z_t = pipe.extract_bits(cfg, images=out.images, num_steps=STEPS)
    jbits, jz = jpipe.extract_bits(jcfg, images=jnp.asarray(out.images.numpy()),
                                   num_steps=STEPS)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(jz), rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    assert bits.shape == (2, 32)


def test_decode_image_matches_generate_decoder(pipes, generated):
    """``decode_image`` (one VAE call) equals the chunked decode of
    ``generate`` up to fp32 rounding (atol 1e-6: the CPU convolutions round
    differently at batch 1 and batch 2); and matches the JAX package's."""
    jpipe, pipe = pipes
    _, _, zt, _, _ = _embedded()
    lat = pipe.generate(zt, guidance_scale=1.0, num_steps=2, decode=False)
    images = pipe.decode_image(lat)
    pipe.vae_chunk = 1  # one image per chunk at any size
    try:
        chunked = pipe.generate(zt, guidance_scale=1.0, num_steps=2)
    finally:
        del pipe.vae_chunk
    torch.testing.assert_close(chunked, images, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        images.numpy(), np.asarray(jpipe.decode_image(jnp.asarray(lat.numpy()))),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("refine", [0, 1])
def test_dpm_closed_loop_matches_jax(pipes, refine):
    """DPM++ both ways (and one refinement iteration per inversion step):
    z_T close to JAX's, equal voted bits."""
    jpipe, pipe = pipes
    cfg, jcfg, zt, jzt, msg = _embedded()
    x0 = pipe.generate(zt, guidance_scale=1.0, num_steps=STEPS, scheduler="DPMs",
                       decode=False)
    jx0 = jpipe.generate(jzt, guidance_scale=1.0, num_steps=STEPS,
                         scheduler="DPMs", decode=False)
    np.testing.assert_allclose(x0.numpy(), np.asarray(jx0), rtol=1e-3, atol=1e-4)
    z_back = pipe.invert(latents=x0, num_steps=STEPS, scheduler="DPMs",
                         refine=refine)
    jz_back = jpipe.invert(latents=jx0, num_steps=STEPS, scheduler="DPMs",
                           refine=refine)
    np.testing.assert_allclose(z_back.numpy(), np.asarray(jz_back), rtol=1e-3,
                               atol=1e-4)
    bits = recover_message_bits(z_back, cfg).numpy()
    np.testing.assert_array_equal(bits, np.asarray(j_recover(jz_back, jcfg)))
    assert (bits == np.unpackbits(np.frombuffer(msg, np.uint8))).all()


def test_v_prediction_closed_loop_matches_jax(pipes):
    """The tiny preset with v-prediction (the 768 presets' schedule), the
    same weights: DDIM closed loop, equal voted bits."""
    jpipe, _ = pipes
    jv = JPipeline(dataclasses.replace(J_TINY, prediction_type="v_prediction"),
                   dtype=jnp.float32)
    v = InversablePipeline(dataclasses.replace(TINY, prediction_type="v_prediction"),
                           device="cpu", dtype=torch.float32)
    load_pipeline_params_(v, jpipe.unet_params, jpipe.vae_params, jpipe.text_params)
    jv.unet_params, jv.vae_params = jpipe.unet_params, jpipe.vae_params
    assert v.schedule.prediction_type == jv.schedule.prediction_type == "v_prediction"
    cfg, jcfg, zt, jzt, msg = _embedded(7)
    z_back = v.invert(latents=v.generate(zt, guidance_scale=1.0, num_steps=STEPS,
                                         decode=False), num_steps=STEPS)
    jz_back = jv.invert(latents=jv.generate(jzt, guidance_scale=1.0,
                                            num_steps=STEPS, decode=False),
                        num_steps=STEPS)
    np.testing.assert_allclose(z_back.numpy(), np.asarray(jz_back), rtol=1e-3,
                               atol=1e-4)
    bits = recover_message_bits(z_back, cfg).numpy()
    np.testing.assert_array_equal(bits, np.asarray(j_recover(jz_back, jcfg)))
