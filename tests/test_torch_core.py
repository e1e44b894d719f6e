"""PyTorch port vs the JAX package: watermark core (CPU).

Keystream words are bit-exact three ways (the port's plain version, the JAX
Pallas kernel in interpret mode, and `cryptography`); embed, quantize, vote
and the full decode chain agree bit for bit on the same inputs.  The port's
latents may differ from the JAX package's by one fp32 ulp of ndtri (the two
libraries' ndtri implementations round differently), which moves no bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gswm.config import GSConfig as JGSConfig
from gswm.core import chacha as jchacha
from gswm.core import decode as jdecode
from gswm.core import embed as jembed
from gswm.eval.metrics import calculate_bit_accuracy as j_bit_accuracy
from gswm.schedulers import ddim as jddim
from gswm.schedulers.schedule import sd_schedule as j_sd_schedule
from gswm_torch.config import GSConfig
from gswm_torch.core import chacha, decode, embed
from gswm_torch.eval.metrics import calculate_bit_accuracy
from gswm_torch.schedulers import ddim
from gswm_torch.schedulers.schedule import sd_schedule

torch.set_num_threads(2)

KEY_HEX = "22" * 32
NONCE_HEX = "33" * 16
# counter low word 2^32 - 3: the 64-bit block counter carries at block 3
CARRY_NONCE = (2**32 - 3).to_bytes(8, "little") + bytes(range(8))


def _cfgs(**kw):
    base = dict(key_hex=KEY_HEX, nonce_hex=NONCE_HEX, message="lthero",
                width=64, height=64, message_bits=32)
    base.update(kw)
    return GSConfig(**base), JGSConfig(**base)


@pytest.mark.parametrize("key,nonce,n_blocks", [
    (bytes.fromhex(KEY_HEX), bytes.fromhex(NONCE_HEX), 32),
    (bytes(range(32)), CARRY_NONCE, 9),
    (bytes(range(5, 37)), bytes(range(100, 116)), 1031),
], ids=["main-path", "counter-carry", "many-blocks"])
def test_keystream_words_three_ways(key, nonce, n_blocks):
    ours = chacha.keystream_words(key, nonce, n_blocks, "cpu").numpy()
    kw, c0, nw = jchacha.key_nonce_to_words(key, nonce)
    pallas = np.asarray(jchacha._keystream_words_pallas(
        jnp.asarray(kw), jnp.uint32(c0 & 0xFFFFFFFF), jnp.uint32(c0 >> 32),
        jnp.asarray(nw), n_blocks, interpret=True))
    np.testing.assert_array_equal(ours.view(np.uint32), pallas)
    golden = jchacha.chacha20_keystream(key, nonce, n_blocks * 64)
    assert ours.astype("<i4").tobytes() == golden


def test_keystream_cpu_uses_plain_version():
    before = chacha.keystream_words.launches
    key, nonce = bytes(32), bytes(16)
    got = chacha.keystream_words(key, nonce, 4, "cpu")
    assert chacha.keystream_words.launches == before
    assert torch.equal(got, chacha.keystream_words_reference(key, nonce, 4, "cpu"))
    assert got.dtype == torch.int32 and got.shape == (4, 16)


def test_keystream_rejects_other_devices():
    with pytest.raises(ValueError):
        chacha.keystream_words(bytes(32), bytes(16), 4, "meta")


@pytest.mark.parametrize("n_bits", [512, 700, 16384])
def test_keystream_bits_match_jax(n_bits):
    key, nonce = bytes(range(32)), CARRY_NONCE
    ours = chacha.keystream_bits(key, nonce, n_bits, "cpu").numpy()
    want = np.asarray(jchacha.keystream_bits(key, nonce, n_bits, backend="xla"))
    np.testing.assert_array_equal(ours, want)


@pytest.mark.parametrize("l,replicate,batch", [
    (1, False, 2), (1, True, 3), (2, False, 2), (3, False, 1)])
def test_embed_matches_jax(l, replicate, batch):
    cfg, jcfg = _cfgs(l=l)
    n_draws = 1 if replicate else batch
    u = np.random.default_rng(l).random((n_draws, cfg.total_elements),
                                        dtype=np.float32)
    lat, msg = embed.embed_latents(cfg, batch=batch, u=u, replicate=replicate,
                                   device="cpu")
    jlat, jmsg = jembed.embed_latents(jcfg, batch=batch, u=jnp.asarray(u),
                                      replicate=replicate)
    assert msg == jmsg
    jlat = np.asarray(jlat)
    assert lat.shape == jlat.shape == (batch, 4, 8, 8)
    assert lat.dtype == torch.float32
    # ndtri implementations round differently: <= a few fp32 ulps
    np.testing.assert_allclose(lat.numpy(), jlat, rtol=0, atol=4e-6)
    np.testing.assert_array_equal(
        decode.quantize_latent_bits(lat, l).numpy(),
        np.asarray(jdecode.quantize_latent_bits(jnp.asarray(jlat), l)))


def test_encrypted_payload_bits_match_jax():
    cfg, jcfg = _cfgs(message_bits=64, message="payload!")
    msg = b"payload!"
    ours = embed.encrypted_payload_bits(cfg.resolved(), msg, "cpu").numpy()
    want = np.asarray(jembed.encrypted_payload_bits(jcfg.resolved(), msg))
    np.testing.assert_array_equal(ours, want)


def test_embed_with_generator_is_seeded_and_roundtrips():
    cfg, _ = _cfgs()
    a, msg = embed.embed_latents(cfg, generator=torch.Generator().manual_seed(3),
                                 batch=2, device="cpu")
    b, _ = embed.embed_latents(cfg, generator=torch.Generator().manual_seed(3),
                               batch=2, device="cpu")
    assert torch.equal(a, b) and not torch.equal(a[0], a[1])
    voted = decode.recover_message_bits(a, cfg).numpy()
    want = np.unpackbits(np.frombuffer(msg, np.uint8))
    np.testing.assert_array_equal(voted, np.stack([want, want]))


@pytest.mark.parametrize("l", [1, 2])
def test_watermarked_latent_is_standard_normal(l):
    """torch's generator cannot reproduce jax's threefry draws, so the port's
    own uniforms are held to the distribution instead: z ~ N(0, 1)."""
    from scipy import stats

    cfg, _ = _cfgs(width=512, height=512, message_bits=256, l=l)
    lat, _ = embed.embed_latents(cfg, generator=torch.Generator().manual_seed(l),
                                 batch=2, device="cpu")
    assert stats.kstest(lat.flatten().numpy(), "norm").pvalue > 1e-3


@pytest.mark.parametrize("l", [1, 2, 3])
def test_quantize_matches_jax(l):
    z = np.random.default_rng(10 + l).standard_normal((2, 4, 8, 8)).astype(np.float32)
    z[0, 0, 0, :4] = [0.0, -0.0, 1e-9, -1e-9]
    ours = decode.quantize_latent_bits(torch.from_numpy(z), l).numpy()
    want = np.asarray(jdecode.quantize_latent_bits(jnp.asarray(z), l))
    np.testing.assert_array_equal(ours, want)


@pytest.mark.parametrize("cap,message_bits", [(64, 16), (70, 16), (96, 32)])
def test_majority_vote_matches_jax(cap, message_bits):
    bits = np.random.default_rng(cap).integers(0, 2, (3, cap), dtype=np.uint8)
    bits[0, :] = 0
    bits[0, :message_bits * (cap // message_bits) // 2] = 1  # ties where even
    ours = decode.majority_vote(torch.from_numpy(bits), message_bits).numpy()
    want = np.asarray(jdecode.majority_vote(jnp.asarray(bits), message_bits))
    np.testing.assert_array_equal(ours, want)


def test_majority_tie_goes_to_zero():
    bits = torch.tensor([[1, 0, 0, 1, 1, 1, 0, 0]], dtype=torch.uint8)
    # two segments of 4: position 0 -> 1,1 ; position 1 -> 0,1 (tie)
    assert decode.majority_vote(bits, 4).tolist() == [[1, 0, 0, 0]]


@pytest.mark.parametrize("noise", [0.0, 0.8, 3.0])
def test_recover_message_bits_matches_jax(noise):
    cfg, jcfg = _cfgs(message_bits=64)
    u = np.random.default_rng(7).random((2, cfg.total_elements), dtype=np.float32)
    jlat, msg = jembed.embed_latents(jcfg, batch=2, u=jnp.asarray(u))
    z = np.asarray(jlat) + noise * np.random.default_rng(8).standard_normal(
        (2, 4, 8, 8)).astype(np.float32)
    ours = decode.recover_message_bits(torch.from_numpy(z), cfg).numpy()
    want = np.asarray(jdecode.recover_message_bits(jnp.asarray(z), jcfg))
    np.testing.assert_array_equal(ours, want)
    assert decode.decode_latents(torch.from_numpy(z[0]), cfg) == \
        jdecode.decode_latents(jnp.asarray(z[0]), jcfg)


def test_config_and_capacity_match_jax():
    for kw in (dict(), dict(width=1024, height=768), dict(width=64, height=64),
               dict(l=2, message_bits=128), dict(key_hex=KEY_HEX, nonce_hex=""),
               dict(repeat4=True, message_bits=64)):
        cfg, jcfg = GSConfig(**kw), JGSConfig(**kw)
        for prop in ("latent_hw", "total_elements", "capacity_bits",
                     "resolved_message_bits", "message_bytes_len", "repeats"):
            assert getattr(cfg, prop) == getattr(jcfg, prop), (kw, prop)
        if kw.get("key_hex"):
            assert cfg.resolve_key_nonce() == jcfg.resolve_key_nonce()
    with pytest.raises(ValueError):
        GSConfig(width=63)
    assert dataclasses.replace(GSConfig(), l=2).capacity_bits == 2 * 16384


def test_bit_accuracy_matches_jax():
    for hex_msg, extracted in (("6c74", "0110110001110100"), ("ff", "0000"),
                               ("0f0f", "00001111000011111111")):
        assert calculate_bit_accuracy(hex_msg, extracted) == \
            j_bit_accuracy(hex_msg, extracted)


@pytest.mark.parametrize("steps", [8, 30, 50])
def test_ddim_plans_match_jax(steps):
    sched, jsched = sd_schedule(), j_sd_schedule()
    for ours_fn, jax_fn in ((ddim.ddim_plan, jddim.ddim_plan),
                            (ddim.ddim_inverse_plan, jddim.ddim_inverse_plan)):
        ours, want = ours_fn(sched, steps), jax_fn(jsched, steps)
        for field in ("t_model", "alpha_eval", "alpha_from", "alpha_to"):
            np.testing.assert_array_equal(getattr(ours, field),
                                          np.asarray(getattr(want, field)))


def test_ddim_step_matches_jax():
    rng = np.random.default_rng(0)
    x, eps = (rng.standard_normal((2, 4, 8, 8)).astype(np.float32) for _ in range(2))
    a_from, a_to = np.float32(0.3), np.float32(0.9)
    ours = ddim.ddim_step(torch.from_numpy(x), torch.from_numpy(eps),
                          torch.tensor(a_from), torch.tensor(a_to)).numpy()
    want = np.asarray(jax.jit(jddim.ddim_step)(x, eps, a_from, a_to))
    np.testing.assert_allclose(ours, want, rtol=1e-6, atol=1e-6)
    v = ddim.to_eps(torch.from_numpy(x), torch.from_numpy(eps), torch.tensor(a_to),
                    "v_prediction").numpy()
    np.testing.assert_allclose(
        v, np.asarray(jddim.to_eps(x, eps, a_to, "v_prediction")), rtol=1e-6,
        atol=1e-6)


def _count_keystream_calls(monkeypatch):
    """Count the calls that reach ``keystream_words`` (on a card: launches)."""
    calls = []
    real = chacha.keystream_words

    def counted(key, nonce16, n_blocks, device="cuda"):
        calls.append((key, nonce16, n_blocks, str(device)))
        return real(key, nonce16, n_blocks, device)

    monkeypatch.setattr(chacha, "keystream_words", counted)
    return calls


def test_keystream_and_payload_are_cached_per_key(monkeypatch):
    """Two embeds and two decodes under one key make one keystream (the JAX
    package's _cached_keystream / _cached_payload_bits), with the same bits
    as the uncached function; another nonce, message, capacity or device is
    another entry."""
    embed.clear_caches()
    calls = _count_keystream_calls(monkeypatch)
    cfg, jcfg = _cfgs()
    u = np.random.default_rng(3).random((1, cfg.total_elements), dtype=np.float32)
    for _ in range(2):
        lat, msg = embed.embed_latents(cfg, u=u, device="cpu")
        voted = decode.recover_message_bits(lat, cfg)
    assert len(calls) == 1
    np.testing.assert_array_equal(voted[0].numpy(),
                                  np.unpackbits(np.frombuffer(msg, np.uint8)))
    key, nonce = cfg.resolve_key_nonce()
    cached = chacha.cached_keystream_bits(key, nonce, cfg.capacity_bits, "cpu")
    assert cached is chacha.cached_keystream_bits(key, nonce, cfg.capacity_bits, "cpu")
    assert torch.equal(cached, chacha.keystream_bits(key, nonce, cfg.capacity_bits, "cpu"))
    assert len(calls) == 2  # the uncached call just above
    payload = embed.encrypted_payload_bits(cfg.resolved(), msg, "cpu")
    assert payload is embed.encrypted_payload_bits(cfg.resolved(), msg, "cpu")
    np.testing.assert_array_equal(
        payload.numpy(), np.asarray(jembed.encrypted_payload_bits(jcfg.resolved(), msg)))
    assert len(calls) == 2
    # a different message: a new payload from the cached keystream
    embed.encrypted_payload_bits(cfg.resolved(), b"abcd", "cpu")
    assert len(calls) == 2
    # a different nonce, capacity or device misses
    other, _ = _cfgs(nonce_hex="44" * 16)
    embed.embed_latents(other, u=u, device="cpu")
    assert len(calls) == 3
    wide, _ = _cfgs(width=128)
    decode.recover_message_bits(torch.zeros((4, 8, 16)), wide)
    assert len(calls) == 4
    with pytest.raises(ValueError):  # the key holds the device
        chacha.cached_keystream_bits(key, nonce, cfg.capacity_bits, "meta")
    assert len(calls) == 5 and calls[-1][3] == "meta"
    embed.clear_caches()
    decode.recover_message_bits(lat, cfg)
    assert len(calls) == 6


def test_cache_is_bounded():
    embed.clear_caches()
    for i in range(40):
        chacha.cached_keystream_bits(bytes([i]) * 32, bytes(16), 64, "cpu")
    info = chacha._cached_keystream_bits.cache_info()
    assert info.maxsize == 32 and info.currsize == 32


def test_canonical_device_fills_in_the_index():
    assert chacha.canonical_device("cpu") == torch.device("cpu")
    assert chacha.canonical_device(torch.device("cuda", 1)) == torch.device("cuda:1")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            chacha.canonical_device("cuda")


def test_words_to_bits_keeps_leading_dims():
    words = torch.from_numpy(np.random.default_rng(1).integers(
        -2**31, 2**31, (3, 2, 16), dtype=np.int64).astype(np.int32))
    bits = chacha.words_to_bits(words)
    assert bits.shape == (3, 1024)
    for r in range(3):
        assert torch.equal(bits[r], chacha.words_to_bits(words[r]))
        want = np.unpackbits(words[r].numpy().astype("<i4").view(np.uint8).ravel())
        np.testing.assert_array_equal(bits[r].numpy(), want)
