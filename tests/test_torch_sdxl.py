"""PyTorch port vs the JAX package: SDXL on the tiny-xl preset.

The JAX ``InversablePipeline("tiny-xl", dtype=float32)`` is built once per
module (its construction is the slow part); the port's pipeline gets its
weights through ``gswm_torch.models.bridge``, the second text encoder's
included.  Both run the same chains on the same numpy inputs.  Tolerances
are test_torch_pipeline.py's: equal voted bits, latents and z_T within rtol
1e-3 / atol 1e-4 (fp32, 8 + 8 UNet evaluations), images likewise; the text
side (``pooled``, ``empty_context``) within rtol 1e-4 / atol 1e-5.  bf16 is
held to test_torch_bf16.py's: 5% of max |out| for the UNet, 0.1 on z_T,
equal bits.  sdxl-base's full-size names and shapes are held against the
JAX package's trees from ``jax.eval_shape``, which allocates nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gswm.config import GSConfig as JGSConfig
from gswm.core.decode import recover_message_bits as j_recover
from gswm.core.embed import embed_latents as j_embed
from gswm.models import configs as jconfigs
from gswm.models.layers import Attention as JAttention
from gswm.models.unet import UNet2DCondition as JUNet
from gswm.pipelines import InversablePipeline as JPipeline
from gswm_torch.config import GSConfig
from gswm_torch.core.decode import recover_message_bits
from gswm_torch.core.embed import embed_latents
from gswm_torch.models.bridge import convert_shapes, load_pipeline_params_
from gswm_torch.models.configs import PRESETS
from gswm_torch.models.text import TextEncoder
from gswm_torch.models.unet import UNet2DCondition
from gswm_torch.ops import attention as attn
from gswm_torch.pipelines import InversablePipeline

torch.set_num_threads(2)

STEPS = 6
BASE = dict(key_hex="22" * 32, nonce_hex="33" * 16, message="xl",
            width=64, height=64, message_bits=32)
VOCAB = PRESETS["tiny-xl"].text.vocab_size
EOS = VOCAB - 1  # min(49407, vocab - 1), the encoders' EOS id
UNET_REL, ZT_ABS = 0.05, 0.1


def _bridge(pipe, jpipe):
    return load_pipeline_params_(pipe, jpipe.unet_params, jpipe.vae_params,
                                 jpipe.text_params, jpipe.text2.params)


@pytest.fixture(scope="module")
def pipes():
    jpipe = JPipeline("tiny-xl", dtype=jnp.float32)
    pipe = _bridge(InversablePipeline("tiny-xl", device="cpu", dtype=torch.float32),
                   jpipe)
    return jpipe, pipe


def _added(batch, seed=3):
    rng = np.random.default_rng(seed)
    return {"text_embeds": rng.standard_normal((batch, 32)).astype(np.float32),
            "time_ids": rng.uniform(0, 1024, (batch, 6)).astype(np.float32)}


def _unet_inputs(batch=2, seed=2):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((batch, 4, 8, 8)).astype(np.float32)
    t = np.array([10, 501][:batch], np.int32)
    ctx = rng.standard_normal((batch, 77, 48)).astype(np.float32)
    return lat, t, ctx


def _torch_added(added):
    return {k: torch.from_numpy(v) for k, v in added.items()}


def test_unet_matches_jax_with_added_cond(pipes):
    """Nonzero time_ids and text_embeds through the addition embeddings."""
    jpipe, pipe = pipes
    lat, t, ctx = _unet_inputs()
    added = _added(2)
    want = jpipe.unet.apply(jpipe.unet_params, lat, t, ctx,
                            {k: jnp.asarray(v) for k, v in added.items()})
    with torch.no_grad():
        got = pipe.unet(torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(ctx),
                        _torch_added(added))
    assert got.shape == (2, 4, 8, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)


def test_time_ids_move_the_output(pipes):
    _, pipe = pipes
    lat, t, ctx = (torch.from_numpy(a) for a in _unet_inputs())
    added = _torch_added(_added(2))
    with torch.no_grad():
        out = pipe.unet(lat, t, ctx, added)
        moved = pipe.unet(lat, t, ctx, dict(added, time_ids=added["time_ids"] + 512.0))
    assert (moved - out).abs().max().item() > 1e-5


def test_unet_requires_added_cond():
    with torch.device("meta"):
        unet = UNet2DCondition(PRESETS["tiny-xl"].unet)
    with pytest.raises(ValueError, match="added_cond"):
        unet(torch.zeros(1, 4, 8, 8, device="meta"), 1,
             torch.zeros(1, 10, 48, device="meta"))


def test_per_level_depth_and_no_attention_at_level_0():
    """tests/test_sdxl.py's structure cases: depth 2 at level 1, no
    attention at level 0, an addition embedding from 32 + 6 x 256 inputs;
    and sdxl-base's depth 10 at level 2 and in the mid block."""
    with torch.device("meta"):
        names = set(UNet2DCondition(PRESETS["tiny-xl"].unet).state_dict())
        xl = UNet2DCondition(PRESETS["sdxl-base"].unet)
    blk = "down_blocks.1.attentions.0.transformer_blocks"
    assert any(n.startswith(f"{blk}.1.") for n in names)
    assert not any(n.startswith(f"{blk}.2.") for n in names)
    assert not any(n.startswith("down_blocks.0.attentions") for n in names)
    assert "add_embedding.linear_1.weight" in names
    assert len(xl.down_blocks[2].attentions[0].transformer_blocks) == 10
    assert len(xl.mid_block.attentions[0].transformer_blocks) == 10
    assert len(xl.up_blocks[0].attentions[2].transformer_blocks) == 10
    assert len(xl.down_blocks[1].attentions[1].transformer_blocks) == 2
    assert not len(xl.down_blocks[0].attentions)
    assert tuple(xl.add_embedding.linear_1.weight.shape) == (1280, 2816)


def _ids(seed, eos: bool):
    ids = np.random.default_rng(seed).integers(0, EOS, (2, 77))
    if eos:
        ids[0, 9], ids[0, 30], ids[1, 76] = EOS, EOS, EOS  # the first one pools
    return ids


@pytest.mark.parametrize("case", ["eos", "no_eos", "projection"])
def test_pooled_matches_flax_pooler(pipes, case):
    """``pooled`` against FlaxCLIPTextModel's pooler_output (the last
    layer after the final LayerNorm at the first EOS, position 0 without
    one, although the encoder's context is the penultimate layer), and
    through a projection against the JAX encoder's ``pooled``."""
    jpipe, pipe = pipes
    ids = _ids(4, eos=case != "no_eos")
    want = np.asarray(jpipe.text2.model(input_ids=jnp.asarray(ids),
                                        params=jpipe.text2.params).pooler_output)
    proj = None
    if case == "projection":
        proj = np.random.default_rng(6).standard_normal((32, 32)).astype(np.float32)
        want = np.asarray(jpipe.text2.pooled(jnp.asarray(ids), projection=proj))
    got = pipe.text2.pooled(ids, projection=None if proj is None else torch.from_numpy(proj))
    assert got.shape == (2, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    if case == "no_eos":  # position 0
        hidden = np.asarray(jpipe.text2.model(input_ids=jnp.asarray(ids),
                                              params=jpipe.text2.params).last_hidden_state)
        np.testing.assert_allclose(got.numpy(), hidden[:, 0], rtol=1e-4, atol=1e-5)


def test_empty_context_pooled_and_added_cond_match_jax(pipes):
    jpipe, pipe = pipes
    want = np.asarray(jpipe.empty_context(2))
    got = pipe.empty_context(2)
    assert got.shape == want.shape == (2, 77, 48)  # 16 + 32 concatenated
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    pooled = pipe.pooled_empty_text(3)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpipe.pooled_empty_text(3)),
                               rtol=1e-4, atol=1e-5)
    assert torch.equal(pooled[0], pooled[2]) and pooled.abs().max() > 1e-6
    added, jadded = pipe.default_added_cond(3, 64, 48), jpipe.default_added_cond(3, 64, 48)
    assert added["time_ids"].dtype == torch.float32
    np.testing.assert_array_equal(added["time_ids"].numpy(), np.asarray(jadded["time_ids"]))
    assert added["time_ids"][0].tolist() == [64, 48, 0, 0, 64, 48]
    np.testing.assert_allclose(added["text_embeds"].numpy(),
                               np.asarray(jadded["text_embeds"]), rtol=1e-4, atol=1e-5)
    custom = torch.ones(3, 32)
    assert torch.equal(pipe.default_added_cond(3, 64, 64, custom)["text_embeds"], custom)
    assert InversablePipeline("tiny", device="meta").default_added_cond(1, 64, 64) is None


def test_encode_prompt_ids_with_a_distinct_second_prompt(pipes):
    jpipe, pipe = pipes
    ids, ids2 = _ids(7, eos=True), _ids(8, eos=False)
    want = np.asarray(jpipe.encode_prompt_ids(jnp.asarray(ids), jnp.asarray(ids2)))
    got = pipe.encode_prompt_ids(ids, ids2)
    assert got.shape == (2, 77, 48)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    same = pipe.encode_prompt_ids(ids)
    torch.testing.assert_close(same[..., :16], got[..., :16], rtol=0, atol=0)
    assert not torch.allclose(same[..., 16:], got[..., 16:])
    np.testing.assert_allclose(
        same.numpy(), np.asarray(jpipe.encode_prompt_ids(jnp.asarray(ids))),
        rtol=1e-4, atol=1e-5)


def _embedded(seed=5):
    cfg, jcfg = GSConfig(**BASE), JGSConfig(**BASE)
    u = np.random.default_rng(seed).random((2, cfg.total_elements), dtype=np.float32)
    zt, msg = embed_latents(cfg, batch=2, u=u, device="cpu")
    jzt, jmsg = j_embed(jcfg, batch=2, u=jnp.asarray(u))
    assert msg == jmsg
    return cfg, jcfg, zt, jzt, msg


def test_closed_loop_bits_equal_jax(pipes):
    """embed(u) -> generate at guidance 1.0 -> invert -> decode: latents and
    z_T close to the JAX package's, voted bits equal to its and to the
    message."""
    jpipe, pipe = pipes
    cfg, jcfg, zt, jzt, msg = _embedded()
    x0 = pipe.generate(zt, guidance_scale=1.0, num_steps=STEPS, decode=False)
    jx0 = jpipe.generate(jzt, guidance_scale=1.0, num_steps=STEPS, decode=False)
    np.testing.assert_allclose(x0.numpy(), np.asarray(jx0), rtol=1e-3, atol=1e-4)
    z_back = pipe.invert(latents=x0, num_steps=STEPS)
    jz_back = jpipe.invert(latents=jx0, num_steps=STEPS)
    np.testing.assert_allclose(z_back.numpy(), np.asarray(jz_back), rtol=1e-3, atol=1e-4)
    bits = recover_message_bits(z_back, cfg).numpy()
    np.testing.assert_array_equal(bits, np.asarray(j_recover(jz_back, jcfg)))
    assert (bits == np.unpackbits(np.frombuffer(msg, np.uint8))).all()


@pytest.fixture(scope="module")
def generated(pipes):
    """Prompt ids through both encoders -> DDIM at guidance 7.5 (added_cond
    doubled with the batch) -> VAE decode, on both sides."""
    jpipe, pipe = pipes
    _, _, zt, jzt, _ = _embedded()
    ids = _ids(21, eos=True)
    images = pipe.generate(zt, prompt_ids=ids, guidance_scale=7.5, num_steps=STEPS)
    jimages = jpipe.generate(jzt, prompt_ids=jnp.asarray(ids), guidance_scale=7.5,
                             num_steps=STEPS)
    return images, np.asarray(jimages)


def test_generate_guided_decoded_matches_jax(generated):
    images, jimages = generated
    assert images.shape == jimages.shape == (2, 3, 16, 16)
    assert 0.0 <= images.min().item() and images.max().item() <= 1.0
    np.testing.assert_allclose(images.numpy(), jimages, rtol=1e-3, atol=1e-4)


def test_extract_bits_from_generated_images_equal_jax(pipes, generated):
    jpipe, pipe = pipes
    images, _ = generated
    cfg, jcfg = GSConfig(**BASE), JGSConfig(**BASE)
    bits, z_t = pipe.extract_bits(cfg, images=images, num_steps=STEPS)
    jbits, jz = jpipe.extract_bits(jcfg, images=jnp.asarray(images.numpy()),
                                   num_steps=STEPS)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(jz), rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    assert bits.shape == (2, 32)


def test_weights_dtype_rounds_as_jax(pipes):
    """fp32 compute with bf16 ``weights_dtype``: every floating UNet and
    VAE parameter, norms too, rounded through bf16 and held fp32, against
    the JAX pipeline built the same way from the same key."""
    jpipe, _ = pipes
    jb = JPipeline("tiny-xl", dtype=jnp.float32, weights_dtype=jnp.bfloat16)
    pipe = _bridge(InversablePipeline("tiny-xl", device="cpu", dtype=torch.float32,
                                      weights_dtype=torch.bfloat16), jpipe)
    for p in (*pipe.unet.parameters(), *pipe.vae.parameters()):
        assert p.dtype == torch.float32 and torch.equal(p, p.bfloat16().float())
    norm = pipe.unet.conv_norm_out.weight
    want = np.asarray(jb.unet_params["params"]["conv_norm_out"]["scale"], np.float32)
    np.testing.assert_array_equal(norm.numpy(), want)
    assert pipe.text2.text_model.final_layer_norm.weight.dtype == torch.float32
    cfg, jcfg, zt, jzt, msg = _embedded(9)
    x0 = pipe.generate(zt, guidance_scale=1.0, num_steps=STEPS, decode=False)
    jx0 = jb.generate(jzt, guidance_scale=1.0, num_steps=STEPS, decode=False)
    np.testing.assert_allclose(x0.numpy(), np.asarray(jx0), rtol=1e-3, atol=1e-4)
    z = np.random.default_rng(10).standard_normal((2, 4, 8, 8)).astype(np.float32)
    np.testing.assert_allclose(pipe.decode_image(torch.from_numpy(z)).numpy(),
                               np.asarray(jb.decode_image(jnp.asarray(z))),
                               rtol=1e-4, atol=1e-5)


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max()


def test_tiny_xl_in_bf16_matches_jax(pipes):
    """bf16 on both sides, the same weights: the UNet with added_cond within
    5% of max |out|; the latent closed loop's z_T within 0.1, equal bits."""
    jpipe, _ = pipes
    jb = JPipeline("tiny-xl", dtype=jnp.bfloat16)
    pipe = _bridge(InversablePipeline("tiny-xl", device="cpu", dtype=torch.bfloat16),
                   jpipe)
    lat, t, ctx = _unet_inputs()
    added = _added(2)
    want = jax.jit(jb.unet.apply)(jpipe.unet_params, lat, t, ctx,
                                  {k: jnp.asarray(v) for k, v in added.items()})
    with torch.no_grad():
        got = pipe.unet(torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(ctx),
                        _torch_added(added))
    assert torch.isfinite(got).all() and _rel(got.numpy(), want) <= UNET_REL
    jb.unet_params, jb.vae_params = jpipe.unet_params, jpipe.vae_params
    cfg, jcfg, zt, jzt, msg = _embedded(11)
    z_back = pipe.invert(latents=pipe.generate(zt, guidance_scale=1.0, num_steps=STEPS,
                                               decode=False), num_steps=STEPS)
    jz_back = jb.invert(latents=jb.generate(jzt, guidance_scale=1.0, num_steps=STEPS,
                                            decode=False), num_steps=STEPS)
    assert np.abs(z_back.numpy() - np.asarray(jz_back)).max() <= ZT_ABS
    bits = recover_message_bits(z_back, cfg).numpy()
    np.testing.assert_array_equal(bits, np.asarray(j_recover(jz_back, jcfg)))
    assert (bits == np.unpackbits(np.frombuffer(msg, np.uint8))).all()


def _jax_text_shapes(cfg):
    """The JAX package's CLIP tree for ``cfg`` (gswm/models/text.py:32-46's
    config) as shapes: FlaxCLIPTextModel without its init, then
    ``jax.eval_shape`` of the init."""
    from transformers import CLIPTextConfig, FlaxCLIPTextModel

    hf = CLIPTextConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.hidden_size * 4, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads, max_position_embeddings=cfg.max_length,
        hidden_act=cfg.hidden_act, bos_token_id=min(49406, cfg.vocab_size - 2),
        eos_token_id=min(49407, cfg.vocab_size - 1))
    model = FlaxCLIPTextModel(hf, _do_init=False)
    return jax.eval_shape(lambda key: model.init_weights(key, (1, cfg.max_length)),
                          jax.random.key(0))


@pytest.mark.parametrize("part", ["unet", "text", "text2"])
def test_sdxl_base_names_and_shapes_equal_jax_trees(part):
    """sdxl-base at full size, nothing allocated: the port's state_dict on
    the meta device against the bridge's names and shapes of the JAX
    package's tree, exactly."""
    jpreset = jconfigs.PRESETS["sdxl-base"]
    if part == "unet":
        tree = jax.eval_shape(JUNet(jpreset.unet).init_params, jax.random.key(0))
        cls = UNet2DCondition
    else:
        tree = _jax_text_shapes(getattr(jpreset, part))
        cls = TextEncoder
    want = convert_shapes(tree)
    with torch.device("meta"):
        module = cls(getattr(PRESETS["sdxl-base"], part))
    ours = {name: tuple(t.shape) for name, t in module.state_dict().items()}
    assert sorted(set(want) - set(ours)) == [] and sorted(set(ours) - set(want)) == []
    assert {k: v for k, v in ours.items() if v != want[k]} == {}
    # diffusers' and transformers' counts; text2's less its 1280 x 1280
    # text_projection, which the port holds beside the encoder
    n = sum(int(np.prod(s)) for s in ours.values())
    assert n == {"unet": 2_567_463_684, "text": 123_060_480, "text2": 693_021_440}[part]


def test_generate_conditions_on_the_empty_prompts_pooled_output(pipes):
    """A reference behaviour kept (gswm/pipelines/inversable.py:304-306):
    ``generate`` with prompt ids still gives the UNet the EMPTY prompt's
    pooled output as text_embeds, on both halves of the guided batch, and
    time_ids from the image size."""
    _, pipe = pipes
    seen = []
    unet = pipe.unet

    class Recorder(torch.nn.Module):
        def forward(self, x, t, ctx, added=None):
            seen.append(added)
            return unet(x, t, ctx, added)

    pipe.unet = Recorder()
    try:
        zt = torch.randn((2, 4, 8, 8), generator=torch.Generator().manual_seed(0))
        pipe.generate(zt, prompt_ids=_ids(12, eos=True), num_steps=1, decode=False)
    finally:
        pipe.unet = unet
    (added,) = seen
    want = pipe.pooled_empty_text(2)
    assert torch.equal(added["text_embeds"], torch.cat([want, want]))
    assert added["time_ids"].tolist() == [[16, 16, 0, 0, 16, 16]] * 4
    prompt = pipe.text2.pooled(_ids(12, eos=True))
    assert not torch.allclose(prompt, want)


def test_sdxl_routes_at_1024_against_jax(monkeypatch):
    """SDXL's self-attention sites at 1024x1024, default switches: level 1
    (4096 tokens, 640 channels, 10 heads) takes the xf tier in both
    packages (K2); level 2 and the mid block (1024 tokens, 1280 channels,
    20 heads) fail the JAX package's fused-qkv VMEM estimate and take its
    split flash kernel, where the port takes K1 (a pinned divergence)."""
    for name in attn.ROUTE_SWITCHES:
        monkeypatch.delenv(name, raising=False)
    for batch in (2, 4):
        for s, c, h, want in ((4096, 640, 10, ("xf", "xf")),
                              (1024, 1280, 20, ("split", "fused_qkv"))):
            mod = JAttention(heads=h, head_dim=64, dtype=jnp.bfloat16)
            x = jax.ShapeDtypeStruct((batch, s, c), jnp.bfloat16)
            jroute = next((r for r in ("xf", "cres", "packed", "transposed", "fused_qkv")
                           if getattr(mod, f"_use_{r}")(x)),
                          "split" if s >= mod._flash_min_seq() else "plain")
            assert (jroute, attn.route_self_attention(s, 64)) == want, (batch, s)
