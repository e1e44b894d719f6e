"""PyTorch port vs the JAX package: per-user keys (``core.multikey``), the bit
helpers, the key registry and the jsonl IO, on the CPU.

Keys, nonces, messages and uniforms come from numpy seeds and go through
both packages.  Keystream bits, quantized bits and voted bits are equal;
embedded latents agree to 4e-6 (the two libraries' ndtri round differently,
tests/test_torch_core.py), which moves no bit.  The cases are those of
tests/test_multikey.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gswm.config import GSConfig as JGSConfig
from gswm.core import bits as jbits
from gswm.core import multikey as jmk
from gswm.core.chacha import chacha20_keystream
from gswm.eval import registry as jregistry
from gswm.utils import io as jio
from gswm_torch.config import GSConfig
from gswm_torch.core import bits as bitops
from gswm_torch.core import chacha, decode, multikey
from gswm_torch.eval import registry
from gswm_torch.utils import io

torch.set_num_threads(2)

# counter low word 2^32 - 2: the 64-bit block counter carries at block 2
CARRY = (2**32 - 2).to_bytes(8, "little")


def _material(n, seed=0):
    rng = np.random.default_rng(seed)
    keys = [rng.bytes(32) for _ in range(n)]
    nonces = [rng.bytes(16) for _ in range(n)]
    msgs = [rng.bytes(32) for _ in range(n)]
    return keys, nonces, msgs


@pytest.mark.parametrize("n_bits", [2048, 700, 16384])
def test_batch_keystream_bits_three_ways(n_bits):
    """The port's rows against the JAX package's vmapped ChaCha core and
    against np.unpackbits of `cryptography`'s keystream bytes (the bit order
    is where a silent error would hide); one row's counter carries."""
    keys, nonces, _ = _material(5)
    nonces[3] = CARRY + nonces[3][8:]
    before = chacha.batch_keystream_bits.launches
    ours = multikey.batch_keystream_bits(keys, nonces, n_bits, "cpu")
    assert chacha.batch_keystream_bits.launches == before  # CPU: plain version
    assert ours.dtype == torch.uint8 and ours.shape == (5, n_bits)
    want = np.asarray(jmk.batch_keystream_bits(keys, nonces, n_bits))
    np.testing.assert_array_equal(ours.numpy(), want)
    for i in range(5):
        golden = np.unpackbits(np.frombuffer(
            chacha20_keystream(keys[i], nonces[i], -(-n_bits // 8)), np.uint8))
        np.testing.assert_array_equal(ours[i].numpy(), golden[:n_bits])


def test_batch_row_is_the_single_key_keystream():
    keys, nonces, _ = _material(3, seed=5)
    ours = multikey.batch_keystream_bits(keys, nonces, 1500, "cpu")
    for i in range(3):
        assert torch.equal(ours[i], chacha.keystream_bits(keys[i], nonces[i], 1500, "cpu"))


def test_host_keystream_matches_cryptography():
    """The numpy ChaCha20 of the trace search's host loop, with a counter
    that carries and one that wraps 2^64."""
    key = bytes(range(32))
    for counter in (0, 2**32 - 1, 2**64 - 2):
        nonce = counter.to_bytes(8, "little") + bytes(range(100, 108))
        for n in (64, 2048, 2048 + 13):
            assert chacha.keystream_bytes_host(key, nonce, n) == \
                chacha20_keystream(key, nonce, n)


def test_batch_keystream_rejects_bad_material():
    keys, nonces, _ = _material(2)
    with pytest.raises(ValueError):
        multikey.batch_keystream_bits(keys, nonces[:1], 64, "cpu")
    with pytest.raises(ValueError):
        multikey.batch_keystream_bits([b"short"], nonces[:1], 64, "cpu")
    with pytest.raises(ValueError):
        multikey.batch_keystream_bits(keys, nonces, 64, "meta")


@pytest.mark.parametrize("l,message_bits", [(1, 256), (2, 128)])
def test_embed_multikey_matches_jax(l, message_bits):
    """The JAX package's own uniform draw goes into both."""
    kw = dict(message_bits=message_bits, l=l, width=128, height=128)
    cfg, jcfg = GSConfig(**kw), JGSConfig(**kw)
    keys, nonces, msgs = _material(4, seed=1)
    msgs = [m[:message_bits // 8] for m in msgs]
    rng = jax.random.key(2)
    jlat, jmsg = jmk.embed_latents_multikey(jcfg, keys, nonces, msgs, rng=rng)
    u = np.array(jax.random.uniform(rng, (4, cfg.total_elements), dtype=jnp.float32))
    lat, msg = multikey.embed_latents_multikey(cfg, keys, nonces, msgs, u=u,
                                               device="cpu")
    assert msg == jmsg
    assert lat.shape == (4, 4, 16, 16) and lat.dtype == torch.float32
    np.testing.assert_allclose(lat.numpy(), np.asarray(jlat), rtol=0, atol=4e-6)
    np.testing.assert_array_equal(
        decode.quantize_latent_bits(lat, l).numpy(),
        np.asarray(jdecode_bits(jlat, l)))
    voted = multikey.recover_message_bits_multikey(lat, cfg, keys, nonces)
    jvoted = np.asarray(jmk.recover_message_bits_multikey(jlat, jcfg, keys, nonces))
    np.testing.assert_array_equal(voted.numpy(), jvoted)
    for i in range(4):
        np.testing.assert_array_equal(voted[i].numpy(), bitops.bytes_to_bits(msg[i]))


def jdecode_bits(jlat, l):
    from gswm.core.decode import quantize_latent_bits

    return quantize_latent_bits(jnp.asarray(jlat), l)


def test_multikey_roundtrip_and_wrong_key():
    cfg = GSConfig(message_bits=256)
    keys, nonces, msgs = _material(6, seed=1)
    lat, msg_bytes = multikey.embed_latents_multikey(
        cfg, keys, nonces, msgs, generator=torch.Generator().manual_seed(2),
        device="cpu")
    assert lat.shape == (6, 4, 64, 64)
    voted = multikey.recover_message_bits_multikey(lat, cfg, keys, nonces).numpy()
    for i in range(6):
        np.testing.assert_array_equal(voted[i], bitops.bytes_to_bits(msg_bytes[i]))
    # decoding row i with key j != i must fail to chance
    wrong = multikey.recover_message_bits_multikey(
        lat, cfg, keys[1:] + keys[:1], nonces[1:] + nonces[:1]).numpy()
    acc = np.mean(wrong[0] == bitops.bytes_to_bits(msg_bytes[0]))
    assert 0.3 < acc < 0.7


def test_multikey_row_matches_single_key_core():
    cfg = GSConfig(message_bits=256)
    keys, nonces, msgs = _material(3, seed=2)
    lat, msg_bytes = multikey.embed_latents_multikey(
        cfg, keys, nonces, msgs, generator=torch.Generator().manual_seed(3),
        device="cpu")
    cfg1 = GSConfig(key_hex=keys[1].hex(), nonce_hex=nonces[1].hex(), message_bits=256)
    voted = decode.recover_message_bits(lat[1], cfg1).numpy()
    np.testing.assert_array_equal(voted, bitops.bytes_to_bits(msg_bytes[1]))


def test_embed_multikey_draws_are_seeded_or_fresh():
    cfg = GSConfig(message_bits=32, width=64, height=64)
    keys, nonces, msgs = _material(2, seed=4)
    msgs = [m[:4] for m in msgs]

    def embed(generator=None):
        return multikey.embed_latents_multikey(cfg, keys, nonces, msgs,
                                               generator=generator, device="cpu")[0]

    a, b = embed(torch.Generator().manual_seed(9)), embed(torch.Generator().manual_seed(9))
    assert torch.equal(a, b)
    assert not torch.equal(embed(), embed())  # unseeded: fresh entropy
    with pytest.raises(ValueError):
        multikey.embed_latents_multikey(cfg, keys, nonces, msgs[:1], device="cpu")


def test_bit_helpers_match_jax():
    bits = np.random.default_rng(3).integers(0, 2, 64, dtype=np.uint8)
    assert bitops.bits_to_bytes(bits) == jbits.bits_to_bytes(bits)
    assert bitops.bits_to_hex(bits) == jbits.bits_to_hex(bits)
    s = jbits.bits_to_bin_str(bits)
    np.testing.assert_array_equal(bitops.bin_str_to_bits(s), jbits.bin_str_to_bits(s))
    for h in ("6c74", "0f", "00ff00", "a" * 64):
        np.testing.assert_array_equal(bitops.hex_to_bits(h), jbits.hex_to_bits(h))
    np.testing.assert_array_equal(bitops.hex_to_bits(bitops.bits_to_hex(bits)), bits)


def test_registry_round_trips_against_the_jax_package(tmp_path):
    """Each package reads what the other wrote: jsonl and info_data.txt."""
    keys, nonces, msgs = _material(3, seed=6)
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    for d, mod in ((ours, registry), (theirs, jregistry)):
        d.mkdir()
        reg = mod.KeyRegistry(str(d))
        for i, (k, n, m) in enumerate(zip(keys, nonces, msgs)):
            reg.record(k, n, m, seed=i, height=512, width=512, message_length=256,
                       image_id=f"img{i}")

    def no_time(records):
        return [{k: v for k, v in r.items() if k != "time"} for r in records]

    mine = registry.KeyRegistry(str(theirs)).load_jsonl()
    other = jregistry.KeyRegistry(str(ours)).load_jsonl()
    assert no_time(mine) == no_time(other) and len(mine) == 3
    assert mine[1]["key_hex"] == keys[1].hex() and mine[2]["image_id"] == "img2"
    txt_mine = registry.parse_info_data_txt(str(theirs / "info_data.txt"))
    txt_other = jregistry.parse_info_data_txt(str(ours / "info_data.txt"))
    assert no_time(txt_mine) == no_time(txt_other)
    assert txt_mine[0]["nonce"] == nonces[0].hex() and txt_mine[0]["randomseed"] == "0"
    assert registry.KeyRegistry(str(tmp_path / "ours"), jsonl=False).load_jsonl() == []


def test_io_round_trips_against_the_jax_package(tmp_path):
    records = [{"a": 1, "b": [1, 2]}, {"a": 2, "b": "x"}]
    io.write_jsonlines(records, str(tmp_path / "ours.jsonl"))
    jio.write_jsonlines(records, str(tmp_path / "theirs.jsonl"))
    assert (tmp_path / "ours.jsonl").read_text() == (tmp_path / "theirs.jsonl").read_text()
    assert io.load_jsonlines(str(tmp_path / "theirs.jsonl")) == records
    assert list(io.read_jsonlines(str(tmp_path / "ours.jsonl"))) == \
        jio.load_jsonlines(str(tmp_path / "ours.jsonl"))
    io.write_jsonlines(records[:1], str(tmp_path / "ours.jsonl"), mode="a")
    assert len(io.load_jsonlines(str(tmp_path / "ours.jsonl"))) == 3
    io.write_json({"k": records}, str(tmp_path / "ours.json"))
    jio.write_json({"k": records}, str(tmp_path / "theirs.json"))
    assert (tmp_path / "ours.json").read_text() == (tmp_path / "theirs.json").read_text()
    assert io.read_json(str(tmp_path / "theirs.json")) == {"k": records}
    assert io.resolve_globs(str(tmp_path / "*.jsonl")) == \
        jio.resolve_globs([str(tmp_path / "*.jsonl")])
