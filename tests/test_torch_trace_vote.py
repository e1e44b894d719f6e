"""The per-user-key vote on packed bits (``chacha.batch_vote``'s plain
version, ``eval.trace.pack_candidates``) against the JAX package, on the CPU.

Records and latents come from numpy seeds.  A latent is written so that it
quantizes to chosen bits (each element at the centre of its quantization
bin), so both packages read the same bits; one record's latent carries that
record's message, and a latent of random bits gives every record a score
near 0.5, so many different match counts are compared.  Scores are equal as
float32, voted bits equal, and the best index is the same.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import ndtri

from gswm.config import GSConfig as JGSConfig
from gswm.core import multikey as jmk
from gswm.core.decode import majority_vote as j_majority_vote
from gswm.eval import trace as jtrace
from gswm_torch import GSConfig
from gswm_torch.core import bits as bitops
from gswm_torch.core import chacha, multikey
from gswm_torch.core.decode import majority_vote, quantize_latent_bits
from gswm_torch.eval import trace

torch.set_num_threads(2)


def _records(n, seed, mb, message_bytes=None):
    rng = np.random.default_rng(seed)
    size = message_bytes or -(-mb // 8)
    return [{"key_hex": rng.bytes(32).hex(), "nonce_hex": rng.bytes(16).hex(),
             "message_hex": rng.bytes(size).hex(), "message_length": mb}
            for _ in range(n)]


def _latent_of(bits, l, shape):
    """float32 latent of ``shape`` whose quantization (floor(ndtr(z) 2^l)) is
    ``bits`` (stream order, l bits an element): each element at the centre
    of its bin."""
    y = bits.reshape(-1, l) @ (1 << np.arange(l - 1, -1, -1))
    return ndtri((y + 0.5) / 2**l).astype(np.float32).reshape(shape)


def _carrying(rec, n_bits, mb):
    """The stream bits that decode to ``rec``'s message under its key."""
    ks = np.unpackbits(np.frombuffer(chacha.keystream_bytes_host(
        bytes.fromhex(rec["key_hex"]), bytes.fromhex(rec["nonce_hex"]),
        -(-n_bits // 8)), np.uint8))[:n_bits]
    msg = bitops.hex_to_bits(rec["message_hex"])[:mb]
    return ks ^ bitops.diffuse_payload(msg, n_bits)


def _probes(records, n_bits, mb, l, shape, seed):
    """A latent carrying record 2's message, and one of random bits."""
    rng = np.random.default_rng(seed)
    return (_latent_of(_carrying(records[2], n_bits, mb), l, shape),
            _latent_of(rng.integers(0, 2, n_bits, dtype=np.uint8), l, shape))


def _assert_same(got, want):
    assert got[0] == want[0] and np.float32(got[1]) == np.float32(want[1])
    np.testing.assert_array_equal(np.float32(got[2]), np.float32(want[2]))


SHAPE = (4, 12, 12)  # a 96x96 image's latent: 576 elements


@pytest.mark.parametrize("l", [1, 2])
@pytest.mark.parametrize("mb", [1, 48, 100, 255, 256, 257, "n_bits"])
def test_trace_vote_matches_jax(mb, l):
    """find_source_device, through the records and through a packed table,
    against the JAX package's; the plain vote on the packed inputs gives the
    same scores and the voted bits of gswm's majority vote."""
    n_bits = int(np.prod(SHAPE)) * l
    mb = n_bits if mb == "n_bits" else mb
    records = _records(7, 100 + mb, mb)
    packed = trace.pack_candidates(records, device="cpu")
    for i, lat in enumerate(_probes(records, n_bits, mb, l, SHAPE, seed=mb + l)):
        want = jtrace.find_source_device(lat, records, l=l)
        got = trace.find_source_device(torch.from_numpy(lat), records, l=l, device="cpu")
        _assert_same(got, want)
        _assert_same(trace.find_source_device(lat, packed, l=l, device="cpu"), want)
        if i == 0:  # a 1-bit message matches half the records
            assert got[1] == 1.0 and (mb == 1 or got[0] == 2)
        # the plain vote's bits: gswm's majority vote of quantized ^ keystream
        q = quantize_latent_bits(torch.from_numpy(lat), l)
        words = chacha.pack_bits(q[None], chacha.block_words(n_bits))
        voted = chacha.batch_vote(packed.table, words, n_bits, mb)
        keys = [bytes.fromhex(r["key_hex"]) for r in records]
        nonces = [bytes.fromhex(r["nonce_hex"]) for r in records]
        ks = np.asarray(jmk.batch_keystream_bits(keys, nonces, n_bits))
        jvoted = np.asarray(j_majority_vote(jnp.asarray(q.numpy()[None] ^ ks), mb))
        np.testing.assert_array_equal(voted.numpy(), jvoted)


@pytest.mark.parametrize("mb", [100, 256, 16900])
def test_trace_vote_matches_jax_at_520(mb):
    """n_bits = 16,900 (a 520x520 image: 4 x 65 x 65), no multiple of 32."""
    shape = (4, 65, 65)
    n_bits = 16900
    records = _records(5, 7 + mb, mb)
    for lat in _probes(records, n_bits, mb, 1, shape, seed=mb):
        want = jtrace.find_source_device(lat, records)
        _assert_same(trace.find_source_device(lat, records, device="cpu"), want)


@pytest.mark.parametrize("mb,l", [(48, 1), (100, 2), (256, 1), (255, 2)])
def test_multikey_decode_matches_jax(mb, l):
    """recover_message_bits_multikey, a latent row a key, and one latent
    under every key, against the JAX package's."""
    n_bits = int(np.prod(SHAPE)) * l
    records = _records(6, 300 + mb, mb)
    keys = [bytes.fromhex(r["key_hex"]) for r in records]
    nonces = [bytes.fromhex(r["nonce_hex"]) for r in records]
    rng = np.random.default_rng(mb)
    lat = np.stack([_latent_of(_carrying(r, n_bits, mb), l, SHAPE) if i % 2 else
                    _latent_of(rng.integers(0, 2, n_bits, dtype=np.uint8), l, SHAPE)
                    for i, r in enumerate(records)])
    cfg = GSConfig(width=96, height=96, message_bits=mb, l=l)
    jcfg = JGSConfig(width=96, height=96, message_bits=mb, l=l)
    before = chacha.batch_vote.launches
    got = multikey.recover_message_bits_multikey(torch.from_numpy(lat), cfg, keys, nonces)
    assert chacha.batch_vote.launches == before  # CPU: the plain version
    want = np.asarray(jmk.recover_message_bits_multikey(jnp.asarray(lat), jcfg, keys, nonces))
    assert got.dtype == torch.uint8 and got.shape == (6, mb)
    np.testing.assert_array_equal(got.numpy(), want)
    for i in (1, 3, 5):  # the rows that carry their own message
        np.testing.assert_array_equal(
            got[i].numpy(), bitops.hex_to_bits(records[i]["message_hex"])[:mb])
    one = multikey.recover_message_bits_multikey(torch.from_numpy(lat[1]), cfg, keys, nonces)
    jone = jmk.recover_message_bits_multikey(jnp.asarray(lat[1]), jcfg, keys, nonces)
    np.testing.assert_array_equal(one.numpy(), np.asarray(jone))


@pytest.mark.parametrize("mb", [4, 32, 64])
def test_even_segment_counts_tie_to_zero(mb):
    """Even segment counts with forced ties: a position with as many ones as
    zeros votes 0, one more one votes 1, as gswm's majority vote."""
    n_bits, segs = 512, 512 // mb
    key, nonce = bytes(range(32)), bytes(range(16))
    table = torch.from_numpy(chacha.key_table([key], [nonce]).view(np.int32))
    ks = chacha.keystream_bits(key, nonce, n_bits, "cpu").numpy()
    payload = np.zeros((segs, mb), np.uint8)
    payload[: segs // 2, :] = 1          # every position ties ...
    payload[segs // 2, 1::2] = 1         # ... but the odd ones have one more 1
    q = payload.reshape(-1) ^ ks
    words = chacha.pack_bits(torch.from_numpy(q)[None], chacha.block_words(n_bits))
    voted = chacha.batch_vote(table, words, n_bits, mb)[0].numpy()
    want = np.asarray(j_majority_vote(jnp.asarray(payload.reshape(-1)), mb))
    np.testing.assert_array_equal(voted, want)
    assert voted.tolist() == [i % 2 for i in range(mb)]
    expected = chacha.pack_bits(torch.zeros((1, mb), dtype=torch.uint8), -(-mb // 32))
    score = chacha.batch_vote(table, words, n_bits, mb, expected)
    assert score.dtype == torch.float32 and score.item() == 0.5


@pytest.mark.parametrize("l", [1, 2, 3])
def test_packing_bit_order(l):
    """pack_bits against quantize_latent_bits and np.packbits, and against
    the keystream's own words: packing the keystream bits gives its words,
    so one XOR of words decrypts 32 stream bits."""
    z = torch.from_numpy(np.random.default_rng(l).normal(size=(4, 9, 7)).astype(np.float32))
    q = quantize_latent_bits(z, l)
    n = q.shape[-1]
    words = chacha.pack_bits(q, chacha.block_words(n))
    assert words.dtype == torch.int32 and words.shape == (chacha.block_words(n),)
    assert torch.equal(chacha.unpack_bits(words, n), q)
    want = np.zeros(4 * chacha.block_words(n), np.uint8)
    packed = np.packbits(q.numpy())
    want[:packed.size] = packed
    np.testing.assert_array_equal(words.numpy(), want.view("<i4"))
    key, nonce = bytes(range(32)), bytes(range(16, 32))
    n_blocks = -(-n // chacha.BLOCK_BITS)
    ks_bits = chacha.keystream_bits(key, nonce, n_blocks * chacha.BLOCK_BITS, "cpu")
    ks_words = chacha.keystream_words(key, nonce, n_blocks, "cpu").reshape(-1)
    assert torch.equal(chacha.pack_bits(ks_bits, 16 * n_blocks), ks_words)
    assert torch.equal(chacha.unpack_bits(ks_words ^ words, n), ks_bits[:n] ^ q)


@pytest.mark.parametrize("mb,message_bytes", [(256, None), (100, None), (7, 3), (48, 32),
                                              (1, 1)])
def test_pack_candidates_matches_the_per_record_parse(mb, message_bytes):
    records = _records(9, mb, mb, message_bytes)
    if mb == 7:  # odd hex lengths: hex_to_bits takes 4 bits a digit
        for r in records:
            r["message_hex"] = r["message_hex"][:5].upper()
    packed = trace.pack_candidates(records, device="cpu")
    keys = [bytes.fromhex(r["key_hex"]) for r in records]
    nonces = [bytes.fromhex(r["nonce_hex"]) for r in records]
    assert packed.message_bits == mb and len(packed) == 9
    np.testing.assert_array_equal(packed.table.numpy(),
                                  chacha.key_table(keys, nonces).view(np.int32))
    want = np.stack([bitops.hex_to_bits(r["message_hex"])[:mb] for r in records])
    ew = -(-mb // 32)
    assert packed.expected.shape == (9, ew) and packed.expected.dtype == torch.int32
    assert torch.equal(packed.expected, chacha.pack_bits(torch.from_numpy(want), ew))
    assert not chacha.unpack_bits(packed.expected, 32 * ew)[:, mb:].any()


def test_pack_candidates_raises_where_the_per_record_parse_raises():
    good = _records(4, 1, 256)
    mixed = good[:2] + _records(2, 2, 128)
    with pytest.raises(ValueError, match="uniform message_bits"):
        trace.pack_candidates(mixed, device="cpu")
    with pytest.raises(ValueError, match="uniform message_bits"):
        trace.find_source_device(np.zeros(SHAPE, np.float32), mixed, device="cpu")
    for field, short in (("key_hex", "ab" * 31), ("nonce_hex", "cd" * 15),
                         ("key_hex", "ab" * 31 + "a b")):
        bad = [dict(r) for r in good]
        bad[2][field] = short
        with pytest.raises(ValueError, match="32-byte keys and 16-byte nonces"):
            trace.pack_candidates(bad, device="cpu")
        with pytest.raises(ValueError):  # the per-record path raises as well
            chacha.key_table([bytes.fromhex(r["key_hex"]) for r in bad],
                             [bytes.fromhex(r["nonce_hex"]) for r in bad])
    bad = [dict(r) for r in good]
    bad[1]["message_hex"] = bad[1]["message_hex"][:60]
    with pytest.raises(ValueError, match="fewer than 256 bits"):
        trace.pack_candidates(bad, device="cpu")
    bad[1]["message_hex"] = "zz" * 32
    with pytest.raises(ValueError):
        trace.pack_candidates(bad, device="cpu")
    with pytest.raises(ValueError, match="no records"):
        trace.pack_candidates([], device="cpu")


def test_records_path_equals_packed_path_and_chunks():
    """1000 records in chunks of 128 (8 calls, the last ragged): the packed
    table gives the records' results, and the chunking changes nothing."""
    records = _records(1000, 5, 256)
    lat = _latent_of(_carrying(records[2], 576, 256), 1, SHAPE)
    packed = trace.pack_candidates(records, device="cpu")
    by_records = trace.find_source_device(lat, records, chunk=128, device="cpu")
    assert by_records == trace.find_source_device(lat, packed, chunk=128, device="cpu")
    assert by_records == trace.find_source_device(lat, packed, device="cpu")
    assert by_records[:2] == (2, 1.0)
    # every score is k / 256 for an integer k
    assert all((np.float32(a) * 256).is_integer() for a in by_records[2])


def test_batch_vote_refuses_what_it_does_not_take():
    records = _records(3, 9, 64)
    packed = trace.pack_candidates(records, device="cpu")
    words = torch.zeros((1, chacha.block_words(300)), dtype=torch.int32)
    assert chacha.batch_vote(packed.table, words, 300, 64, packed.expected).shape == (3,)
    with pytest.raises(ValueError, match="table"):
        chacha.batch_vote(packed.table.to(torch.int64), words, 300, 64)
    with pytest.raises(ValueError, match="latent words"):
        chacha.batch_vote(packed.table, words[:, :-1], 300, 64)
    with pytest.raises(ValueError, match="latent words"):
        chacha.batch_vote(packed.table, words.expand(2, -1), 300, 64)
    with pytest.raises(ValueError, match="expected"):
        chacha.batch_vote(packed.table, words, 300, 64, packed.expected[:2])
    with pytest.raises(ValueError, match="message bits"):
        chacha.batch_vote(packed.table, words, 300, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        chacha.batch_vote(packed.table.to("meta"), words.to("meta"), 300, 64)
    with pytest.raises(ValueError, match="one latent"):
        trace.find_source_device(np.zeros((2, *SHAPE), np.float32), packed, device="cpu")
    with pytest.raises(ValueError, match="latents for"):
        multikey.recover_message_bits_multikey(
            torch.zeros((2, 4, 8, 8)), GSConfig(width=64, height=64, message_bits=32),
            [bytes(32)] * 3, [bytes(16)] * 3)


def test_pack_candidates_defaults_to_the_card():
    import inspect

    assert inspect.signature(trace.pack_candidates).parameters["device"].default == "cuda"


def test_majority_vote_of_unpacked_words_is_the_port_vote():
    """The plain version's parts: unpack_bits of the packed payload and
    majority_vote give decode's chain on the same bits."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.integers(0, 2, (3, 1000), dtype=np.uint8))
    words = chacha.pack_bits(q, chacha.block_words(1000))
    assert torch.equal(majority_vote(chacha.unpack_bits(words, 1000), 96),
                       majority_vote(q, 96))
