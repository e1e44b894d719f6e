"""The port's native host library (``gswm_torch.hostlib``, built by g++
here) against the JAX package's (``gswm.native``) and against its numpy
plain versions (``gswm_torch.eval.trace``, ``core.chacha``): bit for bit on
numpy draws; ``find_source`` on it gives the answers it gave before; a
failed build raises."""

import numpy as np
import pytest

from gswm import native as jnative
from gswm.eval import trace as jtrace
from gswm_torch import hostlib
from gswm_torch.core import bits as bitops
from gswm_torch.core import chacha
from gswm_torch.eval import trace


def _records(n, seed, message_bytes=32):
    rng = np.random.default_rng(seed)
    return [{"key_hex": rng.bytes(32).hex(), "nonce_hex": rng.bytes(16).hex(),
             "message_hex": rng.bytes(message_bytes).hex(),
             "message_length": message_bytes * 8} for _ in range(n)]


def test_library_is_built_here_by_gxx():
    lib = hostlib.library()
    assert lib.path.exists() and lib.path.parent == hostlib.BUILD_DIR
    assert lib.path.name.startswith("libgswm_host_") and lib.path.suffix == ".so"
    assert "-march=native" not in hostlib.FLAGS


@pytest.mark.parametrize("n_bytes,counter", [(1, 0), (64, 7), (2048, 2**32 - 3),
                                             (1000, 2**64 - 2)])
def test_keystream_bit_exact(n_bytes, counter):
    key = bytes(range(32))
    nonce = counter.to_bytes(8, "little") + bytes(range(8))
    got = hostlib.chacha20_keystream(key, nonce, n_bytes)
    assert got == chacha.keystream_bytes_host(key, nonce, n_bytes)
    assert got == jnative.chacha20_keystream(key, nonce, n_bytes)


@pytest.mark.parametrize("l", [1, 2, 3])
def test_quantize_bit_exact(l):
    z = np.random.default_rng(l).standard_normal((4, 8, 8)).astype(np.float32)
    got = hostlib.quantize_bits(z, l)
    np.testing.assert_array_equal(got, trace.quantize_bits_host(z, l))
    np.testing.assert_array_equal(got, jnative.quantize_bits(z, l))


@pytest.mark.parametrize("n_bits,message_bits", [(4096, 256), (1000, 32), (700, 7),
                                                 (96, 32)])
def test_decode_and_match_bit_exact(n_bits, message_bits):
    rng = np.random.default_rng(n_bits)
    qbits = rng.integers(0, 2, n_bits).astype(np.uint8)
    key, nonce = rng.bytes(32), rng.bytes(16)
    got = hostlib.decode(qbits, key, nonce, message_bits)
    np.testing.assert_array_equal(got, trace.decode_host(qbits, key, nonce, message_bits))
    np.testing.assert_array_equal(got, jnative.decode(qbits, key, nonce, message_bits))
    expected = rng.integers(0, 2, message_bits).astype(np.uint8)
    acc = hostlib.match_accuracy(got, expected)
    assert acc == trace.match_accuracy(got, expected) == jnative.match_accuracy(got, expected)


def test_wrong_sizes_raise():
    with pytest.raises(ValueError, match="32-byte key"):
        hostlib.chacha20_keystream(bytes(31), bytes(16), 8)
    with pytest.raises(ValueError, match="expected"):
        hostlib.match_accuracy(np.zeros(4, np.uint8), np.zeros(5, np.uint8))
    with pytest.raises(ValueError, match="message_bits"):
        hostlib.decode(np.zeros(64, np.uint8), bytes(32), bytes(16), 0)
    with pytest.raises(ValueError, match="1 to 30"):
        hostlib.quantize_bits(np.zeros(4, np.float32), 31)


def test_find_source_answers_unchanged():
    """On the library: the numpy loop's accuracies exactly, and the JAX
    package's (its native library); records of two message lengths."""
    records = _records(40, 1) + _records(8, 2, message_bytes=16)
    truth = records[13]
    bits = bitops.hex_to_bits(truth["message_hex"])
    cap = 4 * 8 * 8
    payload = np.resize(bits, cap) ^ np.unpackbits(np.frombuffer(
        chacha.keystream_bytes_host(bytes.fromhex(truth["key_hex"]),
                                    bytes.fromhex(truth["nonce_hex"]), cap // 8), np.uint8))
    rng = np.random.default_rng(3)
    lat = np.where(payload == 1, 1.0, -1.0) * (0.1 + rng.random(cap))
    lat = lat.astype(np.float32).reshape(4, 8, 8)
    best, acc, accs = trace.find_source(lat, records)
    assert (best, acc) == (13, 1.0)
    q = trace.quantize_bits_host(lat)
    plain = [trace.match_accuracy(trace.decode_host(
        q, bytes.fromhex(r["key_hex"]), bytes.fromhex(r["nonce_hex"]), r["message_length"]),
        bitops.hex_to_bits(r["message_hex"])[:r["message_length"]]) for r in records]
    assert accs == plain
    assert (best, acc, accs) == jtrace.find_source(lat, records)


def test_build_failure_raises(tmp_path):
    broken = tmp_path / "gswm_native.cpp"
    broken.write_text(hostlib.SOURCE.read_text() + "\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        hostlib.build(broken, tmp_path / "build")
    assert not list((tmp_path / "build").glob("*.so"))


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(hostlib.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        hostlib.build(hostlib.SOURCE, tmp_path)


def test_library_name_hashes_the_machine(tmp_path, monkeypatch):
    path, seconds = hostlib.build(hostlib.SOURCE, tmp_path)
    assert seconds > 0 and hostlib.build(hostlib.SOURCE, tmp_path) == (path, 0.0)
    monkeypatch.setattr(hostlib.platform, "machine", lambda: "another-arch")
    other, _ = hostlib.build(hostlib.SOURCE, tmp_path)
    assert other != path
