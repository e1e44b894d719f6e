"""PyTorch port vs the JAX package: the trace search (``eval.trace``) on the
CPU, on the cases of tests/test_multikey.py and
tests/test_native_trace_treering.py.

Records come from numpy seeds; the probed latents are embedded latents (the
JAX package's, handed over as numpy), where no element is within a few ulps
of 0, so the host loop's float64 quantization and the batched path's fp32
``ndtr`` give the same bits.  Index, best accuracy and every accuracy are
equal between the packages and between the port's two paths.
"""

import jax
import numpy as np
import pytest
import torch

from gswm import native as jnative
from gswm.config import GSConfig as JGSConfig
from gswm.core.embed import embed_latents as j_embed
from gswm.core.multikey import embed_latents_multikey as j_embed_multikey
from gswm.eval import trace as jtrace
from gswm_torch.core import chacha
from gswm_torch.eval import trace

torch.set_num_threads(2)


def _records(n, seed, message_bytes=32):
    rng = np.random.default_rng(seed)
    return [{"key_hex": rng.bytes(32).hex(), "nonce_hex": rng.bytes(16).hex(),
             "message_hex": rng.bytes(message_bytes).hex(),
             "message_length": message_bytes * 8} for _ in range(n)]


def _embedded(rec, seed):
    """The JAX package's latent for one record, as numpy."""
    cfg = JGSConfig(key_hex=rec["key_hex"], nonce_hex=rec["nonce_hex"],
                    message_bits=rec["message_length"])
    lat, _ = j_embed(cfg, rng=jax.random.key(seed),
                     message_bytes=bytes.fromhex(rec["message_hex"]))
    return np.array(lat)[0]


def test_host_pieces_match_the_jax_package():
    """quantize_bits (l = 1 and 2), decode and match_accuracy of the host
    loop against ``gswm.native`` (its C++ library where it builds, else its
    numpy fallbacks: both are the semantics to keep)."""
    z = np.random.default_rng(0).normal(size=(4, 8, 8)).astype(np.float32)
    for l in (1, 2):
        np.testing.assert_array_equal(trace.quantize_bits_host(z, l),
                                      jnative.quantize_bits(z, l))
    rec = _records(1, 1)[0]
    key, nonce = bytes.fromhex(rec["key_hex"]), bytes.fromhex(rec["nonce_hex"])
    qbits = np.random.default_rng(2).integers(0, 2, 1000, dtype=np.uint8)
    for mb in (32, 48, 500):  # 1000 bits: complete segments only; a tie at 500
        voted = trace.decode_host(qbits, key, nonce, mb)
        np.testing.assert_array_equal(voted, jnative.decode(qbits, key, nonce, mb))
        other = 1 - voted
        other[: mb // 4] = voted[: mb // 4]
        assert trace.match_accuracy(voted, other) == jnative.match_accuracy(voted, other)


def test_host_vote_counts_complete_segments_and_ties_give_zero():
    key, nonce = bytes(32), bytes(16)
    ks = np.unpackbits(np.frombuffer(chacha.keystream_bytes_host(key, nonce, 2), np.uint8))
    # 10 decrypted bits, message of 4: two segments vote, the last 2 bits do not
    payload = np.array([1, 0, 0, 1, 1, 1, 0, 0, 1, 1], np.uint8)
    voted = trace.decode_host(payload ^ ks[:10], key, nonce, 4)
    assert voted.tolist() == [1, 0, 0, 0]  # position 1: 0 and 1, a tie


def test_traceability_search_matches_jax():
    """10 candidates, one correct (tests/test_native_trace_treering.py:57)."""
    records = _records(10, 7)
    lat = _embedded(records[6], 3)
    best, acc, accs = trace.find_source(lat, records)
    jbest, jacc, jaccs = jtrace.find_source(lat, records)
    assert (best, acc) == (jbest, jacc) == (6, 1.0)
    assert accs == jaccs
    assert max(a for i, a in enumerate(accs) if i != 6) < 0.7
    dbest, dacc, daccs = trace.find_source_device(torch.from_numpy(lat), records,
                                                  device="cpu")
    assert (dbest, dacc) == (6, 1.0)
    np.testing.assert_array_equal(np.float32(accs), np.float32(daccs))


def test_traceability_1k_device_matches_host_and_jax():
    """1000 records, chunks of 256 (tests/test_native_trace_treering.py:82):
    the port's batched path, its host loop and the JAX package's two paths
    give the same index and the same accuracies (k / 256, exact in fp32)."""
    records = _records(1000, 11)
    lat = _embedded(records[137], 5)
    before = chacha.batch_keystream_bits.launches
    best_d, acc_d, accs_d = trace.find_source_device(lat, records, chunk=256,
                                                     device="cpu")
    assert chacha.batch_keystream_bits.launches == before  # CPU: plain version
    best_h, acc_h, accs_h = trace.find_source(lat, records)
    jbest_d, jacc_d, jaccs_d = jtrace.find_source_device(lat, records, chunk=256)
    jbest_h, jacc_h, jaccs_h = jtrace.find_source(lat, records)
    assert best_d == best_h == jbest_d == jbest_h == 137
    assert acc_d == acc_h == jacc_d == jacc_h == 1.0
    np.testing.assert_array_equal(np.float32(accs_d), np.float32(jaccs_d))
    np.testing.assert_array_equal(np.float32(accs_h), np.float32(jaccs_h))
    np.testing.assert_array_equal(np.float32(accs_d), np.float32(accs_h))


def test_multikey_attribution_via_trace():
    """Registry of 20 users, one batch embedded under their keys by the JAX
    package; both of the port's paths attribute row 13
    (tests/test_multikey.py:67)."""
    records = _records(20, 3)
    keys = [bytes.fromhex(r["key_hex"]) for r in records]
    nonces = [bytes.fromhex(r["nonce_hex"]) for r in records]
    msgs = [bytes.fromhex(r["message_hex"]) for r in records]
    lat, _ = j_embed_multikey(JGSConfig(message_bits=256), keys, nonces, msgs,
                              rng=jax.random.key(4))
    lat = np.asarray(lat)
    assert trace.find_source(lat[13], records)[:2] == (13, 1.0)
    assert trace.find_source_device(lat[13], records, device="cpu")[:2] == (13, 1.0)
    assert trace.find_source(lat[13], records) == jtrace.find_source(lat[13], records)


def test_mixed_message_lengths_take_the_host_loop():
    """Records of 256 and 128 message bits: ``find_source`` scores each at
    its own length, as the JAX package does; the batched path refuses."""
    records = _records(4, 21) + _records(4, 22, message_bytes=16)
    lat = _embedded(records[5], 9)
    assert trace.find_source(lat, records) == jtrace.find_source(lat, records)
    assert trace.find_source(lat, records)[:2] == (5, 1.0)
    with pytest.raises(ValueError, match="uniform message_bits"):
        trace.find_source_device(lat, records, device="cpu")
    # message_length missing: the argument, then the hex length, decide
    bare = [{k: v for k, v in r.items() if k != "message_length"} for r in records[:4]]
    lat0 = _embedded(records[2], 10)
    assert trace.find_source(lat0, bare, message_bits=256) == \
        jtrace.find_source(lat0, bare, message_bits=256)
    assert trace.find_source_device(lat0, bare, device="cpu")[:2] == (2, 1.0)


def test_find_source_device_l2_matches_jax():
    records = _records(6, 31, message_bytes=16)
    cfg = JGSConfig(key_hex=records[4]["key_hex"], nonce_hex=records[4]["nonce_hex"],
                    message_bits=128, l=2)
    lat, _ = j_embed(cfg, rng=jax.random.key(1),
                     message_bytes=bytes.fromhex(records[4]["message_hex"]))
    lat = np.asarray(lat)[0]
    got = trace.find_source_device(lat, records, l=2, device="cpu")
    want = jtrace.find_source_device(lat, records, l=2)
    assert got[:2] == want[:2] == (4, 1.0)
    np.testing.assert_array_equal(np.float32(got[2]), np.float32(want[2]))
    assert trace.find_source(lat, records, l=2) == jtrace.find_source(lat, records, l=2)
