"""Float32 in the PyTorch port against the JAX package, on the CPU.

On a CUDA device the port runs float32 through two kernels of its own,
csrc/qkv_proj_f32.cu (the q/k/v projection GEMM) and csrc/flash_f32.cu (the
flash core at 8 <= d <= 512): every preset's default route reaches nothing
else.  On the CPU
each wrapper runs its plain version, which is the function those kernels
compute (fp32 products and sums, exact softmax with a running max); the
kernels are held to it on the card (tests/test_torch_gpu.py, chip_smoke.py
phase 13).  Here:

  * the plain versions against the JAX package's float32 kernels: the Pallas
    ``flash_attention_fused_qkv`` in interpret mode at SD 2.x's levels 1 and
    2 (its TPU VMEM gate, which float32 at these widths exceeds, lifted: the
    gate holds a TPU's 16 MB, not what the kernel computes), and
    ``xla_flash_attention`` at level 0's heads with logits far below its
    clamp at 60, and the Pallas ``flash_attention`` (K4, interpret mode) at
    the head dims of SD 1.x (40, 80, 160) and the VAE (512), at Sq != Sk
    with ragged tails past 512 keys, and in the VAE's mid attention layer
    above ``VAE_FLASH_MIN_TOKENS``.  Within 1e-5 of max |want|: two fp32
    computations of one function that sum in other orders (measured 0.6e-6
    to 1.8e-6); TF32 operands read ~5e-4 and bf16 5e-3;
  * the slice as a whole: sd-2-1-base narrowed to 64-wide heads (1, 2 and 4
    heads; channels 64, 128, 256, 256), a 32-wide text encoder and the tiny
    VAE, at 32x32 latents, so that levels 0 and 1 (1024 and 256 tokens) take
    the fused-qkv route in both packages.  The UNet forward within 2e-5 of
    max |out| (measured 1.5e-6 to 2.0e-6) with the JAX package's Pallas
    kernels forced on (``GSWM_FORCE_FLASH=1``, interpret mode); the latent
    closed loop (8 + 8 steps) with equal voted bits and recovered z_T within
    1e-4 (measured 3.6e-6, against an RMS of 0.18 from the embedded z_T);
    and sd-1-4 narrowed to one head of 40, 80 and 160 (channels 40, 80, 160,
    160, GroupNorm of 8 groups), at 32x32 latents with the xf tier from 1024
    tokens (``GSWM_XF_ATTN_MIN_SEQ``, both packages' switch): level 0 takes
    K2 at d = 40, level 1 K1 at d = 80 (the JAX package's Pallas fused-qkv
    kernel); level 2's 64 tokens stay below every kernel in both packages,
    so d = 160 meets the fp32 core in the K4 cases above.  The same bounds;
  * the rule that names the float32 kernel (``dtype_kernel``), over dtype x
    head dim x layout; the costs and bounds of the float32 kernels
    (``roofline``); the pipeline's check for a CUDA device, which passes
    every preset in float32 and refuses float16 before building anything;
    and the TF32 scope of a float32 pipeline on a CUDA device
    (``exact_float32``), whose flags exist on a CPU build too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gswm.ops.attention as jattn
from gswm.config import GSConfig as JGSConfig
from gswm.core.decode import recover_message_bits as j_recover
from gswm.core.embed import embed_latents as j_embed
from gswm.models import configs as jconfigs
from gswm.models import layers as jlayers
from gswm.pipelines import InversablePipeline as JPipeline
from gswm_torch import roofline
from gswm_torch.config import GSConfig
from gswm_torch.core.decode import recover_message_bits
from gswm_torch.core.embed import embed_latents
from gswm_torch.models import configs, layers
from gswm_torch.models.bridge import load_pipeline_params_, load_tree_
from gswm_torch.ops import attention as attn
from gswm_torch.pipelines import InversablePipeline, inversable

torch.set_num_threads(2)

REL = 1e-5
UNET_REL = 2e-5
ZT_ABS = 1e-4
STEPS = 8


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


@pytest.mark.parametrize("s,c,h", [(1024, 640, 10), (256, 1280, 20)],
                         ids=["level1", "level2"])
def test_fused_qkv_matches_jax_kernel_in_fp32(monkeypatch, s, c, h):
    """SD 2.x's levels 1 and 2 at 512x512, batch 1, heads of 64, fp32:
    the port's ``fused_qkv_attention`` (the function of the fp32 GEMM and
    core) against the Pallas kernel, C^-0.5-scale weights keeping q, k and
    v ~N(0, 1)."""
    monkeypatch.setattr(jattn, "_FUSED_QKV_VMEM_BUDGET", 1 << 40)
    x = _rand((1, s, c), 60)
    wq, wk, wv = (_rand((c, h * 64), i, c**-0.5) for i in (61, 62, 63))
    want = np.asarray(jattn.flash_attention_fused_qkv(
        *(jnp.asarray(t) for t in (x, wq, wk, wv)), h, 64, interpret=True))
    before = attn.fused_qkv_attention.launches_f32
    got = attn.fused_qkv_attention(torch.from_numpy(x),
                                   *(torch.from_numpy(w.T.copy()) for w in (wq, wk, wv)), h)
    assert attn.fused_qkv_attention.launches_f32 == before  # CPU: plain version
    assert want.dtype == np.float32 and got.dtype == torch.float32
    assert got.shape == (1, s, h * 64)
    assert _rel(got.numpy(), want) <= REL


def test_flash_matches_jax_xla_flash_in_fp32():
    """UNet level 0's 5 heads of 64 at 1024 tokens, fp32: the port's
    ``flash_attention`` (the fp32 core's function) against the JAX
    package's K2 reference; N(0, 1) q and k keep the logits ~N(0, 1), far
    below the reference's clamp at 60."""
    q, k, v = (_rand((1, 1024, 5 * 64), i) for i in (70, 71, 72))
    want = np.asarray(jattn.xla_flash_attention(*(jnp.asarray(t) for t in (q, k, v)), 5, 64))
    got = attn.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)), 5)
    assert got.dtype == torch.float32 and got.shape == (1, 1024, 320)
    assert _rel(got.numpy(), want) <= REL


@pytest.mark.parametrize("b,sq,sk,h,d", [
    (2, 300, 577, 3, 40), (1, 577, 1001, 2, 80), (2, 130, 600, 2, 160),
    (1, 300, 577, 1, 512)], ids=["d40", "d80", "d160", "d512"])
def test_split_matches_jax_flash_attention_in_fp32(b, sq, sk, h, d):
    """K4 in fp32 at SD 1.x's head dims and the VAE's: the port's
    ``flash_attention_split`` (the function of flash_f32.cu) against the Pallas ``flash_attention`` in
    interpret mode, Sq != Sk, both past 512 keys with ragged tails (no
    multiple of 64 or 128), N(0, 1) q, k and v."""
    q = _rand((b, sq, h, d), 90 + d)
    k, v = (_rand((b, sk, h, d), i + d) for i in (91, 92))
    want = np.asarray(jattn.flash_attention(*(jnp.asarray(t) for t in (q, k, v)),
                                            interpret=True))
    before = attn.flash_attention_split.launches_f32
    got = attn.flash_attention_split(*(torch.from_numpy(t) for t in (q, k, v)))
    assert attn.flash_attention_split.launches_f32 == before  # CPU: plain version
    assert want.dtype == np.float32 and got.dtype == torch.float32
    assert got.shape == (b, sq, h, d)
    assert _rel(got.numpy(), want) <= REL


@pytest.mark.parametrize("b,sq,sk,h,d", [
    (2, 300, 577, 3, 64), (1, 577, 1001, 2, 40), (2, 130, 600, 2, 80),
    (1, 64, 1024, 1, 512)], ids=["d64", "d40", "d80", "d512"])
def test_split_lse_matches_jax_logsumexp_in_fp32(b, sq, sk, h, d):
    """K4 with its log-sum-exp in fp32 (the ring's per-step kernel, whose
    function ``flash_attention_split_lse_reference`` is): the lse against
    ``jax.nn.logsumexp`` of the JAX logits q k^T d^-0.5 within 1e-5 of
    max(1, max |lse|), the output against the Pallas ``flash_attention`` in
    interpret mode within REL, past 512 keys with ragged tails."""
    q = _rand((b, sq, h, d), 110 + d)
    k, v = (_rand((b, sk, h, d), i + d) for i in (111, 112))
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    jlogits = jnp.einsum("bqhd,bkhd->bhqk", jq, jk) * d**-0.5
    want_lse = np.asarray(jax.nn.logsumexp(jlogits, axis=-1))
    want = np.asarray(jattn.flash_attention(jq, jk, jv, interpret=True))
    before = attn.flash_attention_split.lse_launches_f32
    out, lse = attn.flash_attention_split(*(torch.from_numpy(t) for t in (q, k, v)),
                                          return_lse=True)
    assert attn.flash_attention_split.lse_launches_f32 == before  # CPU: plain version
    assert out.dtype == lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    assert np.abs(lse.numpy() - want_lse).max() <= 1e-5 * max(1.0, np.abs(want_lse).max())
    assert _rel(out.numpy(), want) <= REL


def test_vae_attention_matches_jax_in_fp32(monkeypatch):
    """The VAE's mid attention layer in fp32 above ``VAE_FLASH_MIN_TOKENS``
    (65 x 65 = 4225 tokens, one head of d = 512): the port's split wrapper
    (flash_f32.cu's function) against the JAX module's Pallas K4
    (``GSWM_FORCE_FLASH=1``, interpret mode), both above the same token
    threshold."""
    x = _rand((1, 65, 65, 512), 95)
    jmod = jlayers.VAEAttention(dtype=jnp.float32)
    params = jmod.init(jax.random.key(96), x)
    monkeypatch.setenv("GSWM_FORCE_FLASH", "1")
    kernel, jcalls = jattn.flash_attention, []

    def jflash(q, *args, **kwargs):
        jcalls.append(q.shape)
        return kernel(q, *args, **kwargs)

    monkeypatch.setattr(jattn, "flash_attention", jflash)
    want = np.asarray(jmod.apply(params, x)).transpose(0, 3, 1, 2)
    assert jcalls == [(1, 4225, 1, 512)]
    calls = []

    def split(q, k, v):
        calls.append(tuple(q.shape))
        return attn.flash_attention_split(q, k, v)

    monkeypatch.setattr(layers, "flash_attention_split", split)
    mod = layers.VAEAttention(512)
    load_tree_(mod, params)
    with torch.inference_mode():
        got = mod(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert calls == [(1, 4225, 1, 512)] and layers.VAE_FLASH_MIN_TOKENS < 4225
    assert got.dtype == torch.float32 and got.shape == (1, 512, 65, 65)
    assert _rel(got.numpy(), want) <= REL


def _narrowed(c):
    """sd-2-1-base cut in width alone where the route is concerned: heads
    of 64 at every level (1, 2 and 4 of them), a 32-wide text encoder of two
    layers and the tiny VAE; 256x256 images, 32x32 latents."""
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


def test_narrowed_sd21_base_unet_matches_jax_in_fp32(pipes, monkeypatch):
    """One UNet forward at batch 2, 32x32 latents: the port's route takes
    fused-qkv at levels 0 and 1 (5 + 5 sites), the JAX package's its Pallas
    fused-qkv kernel there (interpret mode, GSWM_FORCE_FLASH=1)."""
    import jax

    jpipe, pipe = pipes
    rng = np.random.default_rng(80)
    lat = rng.standard_normal((2, 4, 32, 32)).astype(np.float32)
    t = np.array([10, 501], np.int32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    monkeypatch.setenv("GSWM_FORCE_FLASH", "1")
    kernel, jcalls = jattn.flash_attention_fused_qkv, []

    def jfused(x, *args, **kwargs):
        jcalls.append(x.shape[1])
        return kernel(x, *args, **kwargs)

    monkeypatch.setattr(jattn, "flash_attention_fused_qkv", jfused)
    want = np.asarray(jax.jit(lambda *a: jpipe.unet.apply(*a))(jpipe.unet_params, lat, t, ctx))
    assert sorted(jcalls) == [256] * 5 + [1024] * 5  # traced once a site
    calls = []

    def fused(x, *ws):
        calls.append(x.shape[1])
        return attn.fused_qkv_attention(x, *ws)

    monkeypatch.setattr(layers, "fused_qkv_attention", fused)
    with torch.inference_mode():
        got = pipe.unet(*(torch.from_numpy(a) for a in (lat, t, ctx)))
    assert sorted(calls) == [256] * 5 + [1024] * 5
    assert got.dtype == torch.float32 and got.shape == (2, 4, 32, 32)
    assert _rel(got.numpy(), want) <= UNET_REL


def test_narrowed_sd21_base_closed_loop_bits_equal_jax_in_fp32(pipes):
    """embed(u) -> 8-step generate -> 8-step inversion -> decode, both in
    fp32: equal voted bits, which are the message."""
    jpipe, pipe = pipes
    kw = dict(key_hex="22" * 32, nonce_hex="33" * 16, message="lthero", width=256,
              height=256, message_bits=32)
    cfg, jcfg = GSConfig(**kw), JGSConfig(**kw)
    u = np.random.default_rng(81).random((2, cfg.total_elements), dtype=np.float32)
    zt, msg = embed_latents(cfg, batch=2, u=u, device="cpu")
    jzt, _ = j_embed(jcfg, batch=2, u=jnp.asarray(u))
    assert zt.shape == (2, 4, 32, 32)
    z = pipe.invert(latents=pipe.generate(zt, guidance_scale=1.0, num_steps=STEPS,
                                          decode=False), num_steps=STEPS)
    jz = jpipe.invert(latents=jpipe.generate(jzt, guidance_scale=1.0, num_steps=STEPS,
                                             decode=False), num_steps=STEPS)
    assert z.dtype == torch.float32
    assert np.abs(z.numpy() - np.asarray(jz)).max() <= ZT_ABS
    bits = recover_message_bits(z, cfg).numpy()
    np.testing.assert_array_equal(bits, np.asarray(j_recover(jz, jcfg)))
    assert (bits == np.unpackbits(np.frombuffer(msg, np.uint8))).all()


def _narrowed_sd14(c):
    """sd-1-4 cut in width alone where the route is concerned: one head of
    40, 80 and 160 (channels 40, 80, 160, 160; GroupNorm of 8 groups, which
    40 channels take), a 32-wide text encoder of two layers and the tiny
    VAE; 256x256 images, 32x32 latents."""
    base = c.SD_1_4
    unet = dataclasses.replace(base.unet, block_out_channels=(40, 80, 160, 160),
                               num_heads=1, norm_groups=8, cross_attn_dim=32)
    text = dataclasses.replace(base.text, vocab_size=1000, hidden_size=32, num_layers=2,
                               num_heads=2)
    return dataclasses.replace(base, name="sd-1-4, narrowed", unet=unet, vae=c.TINY.vae,
                               text=text, default_resolution=256)


@pytest.fixture(scope="module")
def sd14_pipes():
    """Both packages' narrowed sd-1-4 on the same weights, the xf tier from
    1024 tokens (level 0) for every test of the pair: a switch the JAX
    package reads while it traces, so it holds from the first trace on."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GSWM_XF_ATTN_MIN_SEQ", "1024")
        jpipe = JPipeline(_narrowed_sd14(jconfigs), dtype=jnp.float32)
        pipe = InversablePipeline(_narrowed_sd14(configs), device="cpu",
                                  dtype=torch.float32)
        load_pipeline_params_(pipe, jpipe.unet_params, jpipe.vae_params, jpipe.text_params)
        yield jpipe, pipe


def test_narrowed_sd14_unet_matches_jax_in_fp32(sd14_pipes, monkeypatch):
    """One UNet forward at batch 2, 32x32 latents: the port's route takes
    K2 at d = 40 (level 0's 5 sites, 1024 tokens) and K1 at d = 80 (level
    1's 5, 256 tokens); the JAX package its xf tier and its Pallas
    fused-qkv kernel there (interpret mode, GSWM_FORCE_FLASH=1)."""
    import jax

    jpipe, pipe = sd14_pipes
    rng = np.random.default_rng(82)
    lat = rng.standard_normal((2, 4, 32, 32)).astype(np.float32)
    t = np.array([10, 501], np.int32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    monkeypatch.setenv("GSWM_FORCE_FLASH", "1")
    kernel, jcalls = jattn.flash_attention_fused_qkv, []

    def jfused(x, *args, **kwargs):
        jcalls.append((x.shape[1], args[-1] if len(args) > 4 else kwargs.get("head_dim")))
        return kernel(x, *args, **kwargs)

    monkeypatch.setattr(jattn, "flash_attention_fused_qkv", jfused)
    want = np.asarray(jax.jit(lambda *a: jpipe.unet.apply(*a))(jpipe.unet_params, lat, t, ctx))
    assert sorted(jcalls) == [(256, 80)] * 5  # traced once a site
    calls = []

    def record(name):
        real = getattr(layers, name)

        def call(x, *args):
            calls.append((name, x.shape[1], x.shape[2] // args[-1]))
            return real(x, *args)
        monkeypatch.setattr(layers, name, call)

    record("fused_qkv_attention")
    record("flash_attention")
    with torch.inference_mode():
        got = pipe.unet(*(torch.from_numpy(a) for a in (lat, t, ctx)))
    assert sorted(calls) == [("flash_attention", 1024, 40)] * 5 + \
        [("fused_qkv_attention", 256, 80)] * 5
    assert got.dtype == torch.float32 and got.shape == (2, 4, 32, 32)
    assert _rel(got.numpy(), want) <= UNET_REL


def test_narrowed_sd14_closed_loop_bits_equal_jax_in_fp32(sd14_pipes, monkeypatch):
    """embed(u) -> 8-step generate -> 8-step inversion -> decode, both in
    fp32: equal voted bits, which are the message."""
    jpipe, pipe = sd14_pipes
    monkeypatch.setenv("GSWM_XF_ATTN_MIN_SEQ", "1024")
    kw = dict(key_hex="22" * 32, nonce_hex="33" * 16, message="lthero", width=256,
              height=256, message_bits=32)
    cfg, jcfg = GSConfig(**kw), JGSConfig(**kw)
    u = np.random.default_rng(83).random((2, cfg.total_elements), dtype=np.float32)
    zt, msg = embed_latents(cfg, batch=2, u=u, device="cpu")
    jzt, _ = j_embed(jcfg, batch=2, u=jnp.asarray(u))
    z = pipe.invert(latents=pipe.generate(zt, guidance_scale=1.0, num_steps=STEPS,
                                          decode=False), num_steps=STEPS)
    jz = jpipe.invert(latents=jpipe.generate(jzt, guidance_scale=1.0, num_steps=STEPS,
                                             decode=False), num_steps=STEPS)
    assert z.dtype == torch.float32
    assert np.abs(z.numpy() - np.asarray(jz)).max() <= ZT_ABS
    bits = recover_message_bits(z, cfg).numpy()
    np.testing.assert_array_equal(bits, np.asarray(j_recover(jz, jcfg)))
    assert (bits == np.unpackbits(np.frombuffer(msg, np.uint8))).all()


@pytest.mark.parametrize("layout", attn.LAYOUTS)
@pytest.mark.parametrize("d", [40, 64, 80, 160, 512, 8, 56, 72, 128, 192, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16],
                         ids=str)
def test_dtype_kernel_names_the_float32_kernel(dtype, d, layout):
    """bf16: the kernel ``head_dim_kernel`` names; fp32: csrc/flash_f32.cu's
    kernel at d's count of 64-column panels and p v's last width (exact at
    40, 80, 160), in the transposed layout its transposed instance;
    float16: a TypeError naming it."""
    if dtype == torch.bfloat16:
        assert attn.dtype_kernel(dtype, d, layout) == attn.head_dim_kernel(d, layout)[0]
    elif dtype == torch.float32 and layout == "natural":
        tail = attn.F32_EXACT_TAILS.get(d, 64)
        assert attn.dtype_kernel(dtype, d, layout) == \
            f"flash_f32_kernel<{(d + 63) // 64}, {tail}>"
        assert attn._flash_entry(dtype, d) == "gswm_flash_f32_core"
    elif dtype == torch.float32:
        tail = attn.F32_EXACT_TAILS.get(d, 64)
        assert attn.dtype_kernel(dtype, d, layout) == \
            f"flash_f32_kernel<{(d + 63) // 64}, {tail}, transposed>"
    else:
        with pytest.raises(TypeError, match=str(dtype)):
            attn.dtype_kernel(dtype, d, layout)


def test_dtype_kernel_keeps_the_head_dim_and_layout_checks():
    """A head dim no kernel takes, a layout that does not exist, and the
    pair-packed layout (d = 64 alone) at another d: ValueError."""
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError):
            attn.dtype_kernel(dtype, 36)
        with pytest.raises(ValueError):
            attn.dtype_kernel(dtype, 64, "diagonal")
        with pytest.raises(ValueError):
            attn.dtype_kernel(dtype, 80, "packed")


def test_float32_costs_and_bounds():
    """4 bytes an element, and the products at 3xTF32 (PEAK_TF32 / 3):
    K1's GEMM at level 1, batch 4, and the core at level 0, by hand."""
    assert roofline.PEAK_F32_PRODUCTS == pytest.approx(494.5e12 / 3)
    ops, nbytes = roofline.projection_cost(4096, 640, 640, roofline.F32)
    assert (ops, nbytes) == (2 * 4096 * 640 * 1920,
                             4 * (4096 * 640 + 3 * 640 * 640 + 3 * 4096 * 640))
    assert nbytes == 2 * roofline.projection_cost(4096, 640, 640)[1]
    ms, by = roofline.bound_ms(ops, nbytes, roofline.PEAK_F32_PRODUCTS)
    assert by == "operations" and ms == pytest.approx(0.06109, rel=1e-3)
    cost = roofline.attention_cost(4, 4096, 4096, 5, 64, elem=roofline.F32)
    assert cost == (4 * 4 * 5 * 4096**2 * 64, 4 * 4 * 5 * 64 * 4 * 4096, 4 * 5 * 4096**2)
    ms, by = roofline.attention_bound_ms(cost, roofline.PEAK_F32_PRODUCTS)
    assert by == "operations" and ms == pytest.approx(0.52121, rel=1e-3)
    # the bf16 bound of the same work stays the tensor cores' and exponentials'
    assert roofline.attention_bound_ms(roofline.attention_cost(4, 4096, 4096, 5, 64)) == \
        roofline.bound_ms(cost[0], cost[1] / 2, roofline.PEAK_BF16, cost[2])


@pytest.mark.parametrize("shape,gflop,ms", [
    ((1, 9216, 1, 512), 173.9, 1.055), ((1, 16384, 1, 512), 549.8, 3.336),
    ((4, 4096, 8, 40), 85.9, 0.5212), ((4, 1024, 8, 80), 10.74, 0.06515),
    ((4, 256, 8, 160), 1.342, 0.008144)], ids=["vae768", "vae1024", "d40", "d80", "d160"])
def test_float32_bounds_of_the_new_widths(shape, gflop, ms):
    """The fp32 core at the VAE's d = 512 (768x768 and 1024x1024) and SD
    1.x's 40, 80 and 160, by hand: 4 B H Sq Sk d FLOP at 3xTF32; the
    products bind every one (the exponentials, B H S^2 at 16 a clock an
    SM, and the bytes stay below)."""
    b, s, h, d = shape
    cost = roofline.attention_cost(b, s, s, h, d, elem=roofline.F32)
    assert cost == (4 * b * h * s * s * d, 4 * b * h * d * 4 * s, b * h * s * s)
    assert cost[0] / 1e9 == pytest.approx(gflop, rel=1e-3)
    got, by = roofline.attention_bound_ms(cost, roofline.PEAK_F32_PRODUCTS)
    assert by == "operations" and got == pytest.approx(ms, rel=1e-3)
    assert cost[0] / roofline.PEAK_F32_PRODUCTS > max(cost[2] / roofline.PEAK_EXP2,
                                                      cost[1] / roofline.PEAK_BYTES)


@pytest.mark.parametrize("preset", ["sd-2-1", "sd-2-0", "sd-1-4", "sdxl-base",
                                    "sd-2-1-base", "sd-2-0-base"])
def test_check_served_passes_every_preset_in_float32(preset):
    """On a CUDA device every preset's default route reaches only kernels
    that take float32 (heads of 40 ... 160 and 64 on the fp32 core, and
    the VAE's d = 512 on it above 4096 tokens), so the check passes
    float32, as bfloat16; float16 is refused, naming it.  The check builds
    nothing: it reads the preset's configuration alone."""
    from gswm_torch.models.configs import PRESETS

    for dtype in (torch.float32, torch.bfloat16):
        assert inversable._check_served_on_cuda(PRESETS[preset], dtype) is None
    with pytest.raises(NotImplementedError, match="torch.float16"):
        inversable._check_served_on_cuda(PRESETS[preset], torch.float16)


def _flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


@pytest.fixture
def tf32_on(monkeypatch):
    """Both TF32 flags on (PyTorch's default for cuDNN), restored after."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)


@pytest.mark.parametrize("device,dtype,inside", [
    ("cuda", torch.float32, (False, False)),
    (torch.device("cuda:0"), torch.float32, (False, False)),
    ("cuda", torch.bfloat16, (True, True)),
    ("cpu", torch.float32, (True, True))])
def test_exact_float32_turns_tf32_off_on_the_card_alone(tf32_on, device, dtype, inside):
    """Within ``exact_float32`` both flags are off for float32 on a CUDA
    device, and untouched elsewhere; after it they are as before, also when
    the block raises."""
    with inversable.exact_float32(device, dtype):
        assert _flags() == inside
    assert _flags() == (True, True)
    with pytest.raises(RuntimeError, match="inside"):
        with inversable.exact_float32(device, dtype):
            raise RuntimeError("inside")
    assert _flags() == (True, True)


def test_float32_pipeline_runs_every_model_call_without_tf32(tf32_on, monkeypatch):
    """A float32 pipeline bound for a CUDA device computes every UNet, VAE
    and text-encoder call of its public methods with both TF32 flags off,
    and leaves them as it found them.  The tiny preset on the CPU stands in
    for the card: ``exact_float32`` is told its device is "cuda", nothing
    else changes."""
    real = inversable.exact_float32
    monkeypatch.setattr(inversable, "exact_float32",
                        lambda device, dtype: real("cuda", dtype))
    pipe = InversablePipeline("tiny", device="cpu", dtype=torch.float32)
    seen = []
    for model in (pipe.unet, pipe.vae, pipe.text):
        for mod in model.modules():
            if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
                mod.register_forward_pre_hook(lambda *_: seen.append(_flags()))
    cfg = GSConfig(key_hex="22" * 32, nonce_hex="33" * 16, message="lthero", width=64,
                   height=64, message_bits=32)
    zt, _ = embed_latents(cfg, batch=1, u=np.full((1, cfg.total_elements), 0.3, np.float32),
                          device="cpu")
    images = pipe.generate(zt, prompt_ids=np.zeros((1, 77), int), num_steps=2)
    pipe.extract_bits(cfg, images=images, num_steps=2)
    pipe.get_image_latents(images)
    pipe.decode_image(zt)
    assert len(seen) > 100 and set(seen) == {(False, False)}
    assert _flags() == (True, True)
