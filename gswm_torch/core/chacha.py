"""ChaCha20 keystream generation — PyTorch port of ``gswm.core.chacha``.

The reference encrypts the diffused payload with `cryptography`'s ChaCha20,
whose 16-byte "nonce" is ``initial_counter (8B little-endian) || nonce (8B)``
of D. J. Bernstein's original ChaCha20.  The keystream must be bit-identical
to that library's, so every image the reference marked still decodes.

Implementations, bit-identical:
  * ``keystream_words_reference`` / ``batch_keystream_bits_reference`` —
    vectorised torch on int64 tensors that emulate uint32 (masking after
    every add and rotate); any device.
  * the CUDA kernels of ``csrc/chacha20.cu`` — one thread per 64-byte block:
    ``keystream_words`` for one key, ``batch_keystream_bits`` for a table of
    (key, nonce) rows in ONE launch, written as bits.
  * ``keystream_bytes_host`` — numpy on uint32: the plain version of the
    host loop's keystream (``eval.trace.decode_host``), which
    ``eval.trace.find_source`` runs in ``hostlib``'s C++.

``keystream_words`` and ``batch_keystream_bits`` pick by device: the plain
version for the CPU, the kernel for a CUDA device.
``cached_keystream_bits`` keeps the single-key keystream per (key, nonce,
length, device), as the JAX package's ``_cached_keystream`` does, so a
serving loop under one key launches the kernel once.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from gswm_torch import native

_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
_MASK = 0xFFFFFFFF

BLOCK_BITS = 512
# the column round, then the diagonal round (one double round)
_ROUND = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
          (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14))


def key_nonce_to_words(key: bytes, nonce16: bytes) -> tuple[np.ndarray, int, np.ndarray]:
    """Split (key, 16-byte nonce) into (key words[8], initial counter, nonce words[2]).

    Matches `cryptography`'s layout: counter = nonce16[:8] little-endian,
    nonce = nonce16[8:].
    """
    if len(key) != 32 or len(nonce16) != 16:
        raise ValueError("ChaCha20 needs a 32-byte key and 16-byte nonce")
    key_words = np.frombuffer(key, dtype="<u4").astype(np.uint32)
    counter = int.from_bytes(nonce16[:8], "little")
    nonce_words = np.frombuffer(nonce16[8:], dtype="<u4").astype(np.uint32)
    return key_words, counter, nonce_words


def _rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x << n) | (x >> (32 - n))) & _MASK


def _quarter_round(x: list, a: int, b: int, c: int, d: int) -> None:
    x[a] = (x[a] + x[b]) & _MASK
    x[d] = _rotl(x[d] ^ x[a], 16)
    x[c] = (x[c] + x[d]) & _MASK
    x[b] = _rotl(x[b] ^ x[c], 12)
    x[a] = (x[a] + x[b]) & _MASK
    x[d] = _rotl(x[d] ^ x[a], 8)
    x[c] = (x[c] + x[d]) & _MASK
    x[b] = _rotl(x[b] ^ x[c], 7)


def _table_words_reference(table: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """(R, 12) int64 rows of key[8], counter lo, counter hi, nonce[2] (each a
    uint32 value) -> (R, n_blocks, 16) int32 keystream words."""
    idx = torch.arange(n_blocks, dtype=torch.int64, device=table.device)
    lo = table[:, 8, None] + idx
    hi = (table[:, 9, None] + (lo >> 32)) & _MASK  # carry into the high word
    lo = lo & _MASK

    def full(v):
        return v[:, None].expand(-1, n_blocks)

    init = [torch.full_like(lo, c) for c in _CONSTANTS]
    init += [full(table[:, i]) for i in range(8)]
    init += [lo, hi, full(table[:, 10]), full(table[:, 11])]
    x = list(init)
    for _ in range(10):
        for a, b, c, d in _ROUND:
            _quarter_round(x, a, b, c, d)
    words = torch.stack([(xi + ii) & _MASK for xi, ii in zip(x, init)], dim=-1)
    # reinterpret uint32 as int32: values >= 2^31 wrap to negative
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def key_table(keys: Sequence[bytes], nonces: Sequence[bytes]) -> np.ndarray:
    """(R, 12) uint32 rows of key[8], counter lo, counter hi, nonce[2]: a
    16-byte nonce is already those four little-endian words."""
    if len(keys) != len(nonces) or not keys:
        raise ValueError(f"{len(keys)} keys for {len(nonces)} nonces")
    if set(map(len, keys)) != {32} or set(map(len, nonces)) != {16}:
        raise ValueError("ChaCha20 needs 32-byte keys and 16-byte nonces")
    rows = len(keys)
    return np.concatenate(
        [np.frombuffer(b"".join(keys), dtype="<u4").reshape(rows, 8),
         np.frombuffer(b"".join(nonces), dtype="<u4").reshape(rows, 4)], axis=1)


def keystream_words_reference(key: bytes, nonce16: bytes, n_blocks: int,
                              device="cuda") -> torch.Tensor:
    """Plain version: (n_blocks, 16) int32 words (the uint32 bit pattern)."""
    table = torch.from_numpy(key_table([key], [nonce16]).astype(np.int64))
    return _table_words_reference(table.to(device), n_blocks)[0]


def keystream_words(key: bytes, nonce16: bytes, n_blocks: int,
                    device="cuda") -> torch.Tensor:
    """Keystream as (n_blocks, 16) int32 words on ``device`` (bit pattern of
    the uint32 words).  CPU: the plain version.  CUDA: the kernel."""
    device = torch.device(device)
    if device.type == "cpu":
        return keystream_words_reference(key, nonce16, n_blocks, device)
    if device.type != "cuda":
        raise ValueError(f"keystream_words: unsupported device {device}")
    if n_blocks < 1 or n_blocks >= 2**31 // 16:
        raise ValueError(f"keystream_words: n_blocks={n_blocks} out of range")
    key_words, counter0, nonce_words = key_nonce_to_words(key, nonce16)
    words12 = (ctypes.c_uint32 * 12)(
        *key_words.tolist(), counter0 & _MASK, counter0 >> 32,
        *nonce_words.tolist())
    out = torch.empty((n_blocks, 16), dtype=torch.int32, device=device)
    native.launch(out.device, "gswm_chacha20_words", ctypes.addressof(words12),
                  out.data_ptr(), n_blocks)
    keystream_words.launches += 1
    return out


keystream_words.launches = 0


def words_to_bits(words: torch.Tensor) -> torch.Tensor:
    """(..., n_blocks, 16) words -> (..., n_blocks*512) uint8 bits in *stream
    order*.

    Stream order = bytes little-endian within each word, bits MSB-first within
    each byte — exactly the order of ``''.join(format(byte, '08b') ...)`` over
    the byte stream (gs_insert.py:49).
    """
    j = torch.arange(32, dtype=torch.int64, device=words.device)
    shifts = 8 * (j // 8) + (7 - j % 8)  # (32,)
    w = words.to(torch.int64) & _MASK
    bits = (w[..., None] >> shifts) & 1
    return bits.reshape(words.shape[:-2] + (words.shape[-2] * BLOCK_BITS,)).to(
        torch.uint8)


def keystream_bits(key: bytes, nonce16: bytes, n_bits: int,
                   device="cuda") -> torch.Tensor:
    """First ``n_bits`` keystream bits, stream order, on ``device``."""
    n_blocks = -(-n_bits // BLOCK_BITS)
    return words_to_bits(keystream_words(key, nonce16, n_blocks, device))[:n_bits]


def canonical_device(device) -> torch.device:
    """``device`` with its index filled in, so that "cuda" and "cuda:0" are
    one key of a cache.  Raises where "cuda" is asked for without a card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@functools.lru_cache(maxsize=32)
def _cached_keystream_bits(key: bytes, nonce16: bytes, n_bits: int,
                           device: torch.device) -> torch.Tensor:
    return keystream_bits(key, nonce16, n_bits, device)


def cached_keystream_bits(key: bytes, nonce16: bytes, n_bits: int,
                          device="cuda") -> torch.Tensor:
    """``keystream_bits`` kept per (key, nonce, length, device), at most 32 of
    them (the JAX package's ``_cached_keystream``, gswm/core/decode.py:62-66).
    The tensor is shared between callers: read it, never write into it."""
    return _cached_keystream_bits(key, nonce16, n_bits, canonical_device(device))


def clear_caches() -> None:
    """Forget every cached keystream."""
    _cached_keystream_bits.cache_clear()


def batch_keystream_bits_reference(keys: Sequence[bytes], nonces: Sequence[bytes],
                                   n_bits: int, device="cuda") -> torch.Tensor:
    """Plain version of ``batch_keystream_bits``: the int64 emulation over
    all rows at once, 8 bytes a bit on the way."""
    table = torch.from_numpy(key_table(keys, nonces).astype(np.int64)).to(device)
    n_blocks = -(-n_bits // BLOCK_BITS)
    return words_to_bits(_table_words_reference(table, n_blocks))[:, :n_bits]


def batch_keystream_bits(keys: Sequence[bytes], nonces: Sequence[bytes],
                         n_bits: int, device="cuda") -> torch.Tensor:
    """(R, n_bits) uint8 keystream bits in stream order, one (key, nonce)
    pair a row (``gswm.core.multikey.batch_keystream_bits``).  CPU: the plain
    version.  CUDA: one host-to-device copy of the 48-byte rows and ONE
    launch of the batch kernel, which writes the bits themselves: no words
    and no 64-bit intermediate reach device memory."""
    device = torch.device(device)
    if device.type == "cpu":
        return batch_keystream_bits_reference(keys, nonces, n_bits, device)
    if device.type != "cuda":
        raise ValueError(f"batch_keystream_bits: unsupported device {device}")
    table = key_table(keys, nonces)
    rows = table.shape[0]
    n_blocks = -(-n_bits // BLOCK_BITS)
    if n_bits < 1 or rows * n_blocks >= 2**31:
        raise ValueError(f"batch_keystream_bits: {rows} rows of {n_bits} bits "
                         "out of range")
    dev_table = torch.from_numpy(table.view(np.int32)).to(device)
    out = torch.empty((rows, n_bits), dtype=torch.uint8, device=device)
    native.launch(out.device, "gswm_chacha20_batch", dev_table.data_ptr(),
                  out.data_ptr(), rows, n_bits)
    batch_keystream_bits.launches += 1
    return out


batch_keystream_bits.launches = 0


def _rotl_host(x: np.ndarray, n: int) -> np.ndarray:
    return (x << np.uint32(n)) | (x >> np.uint32(32 - n))


def keystream_bytes_host(key: bytes, nonce16: bytes, n_bytes: int) -> bytes:
    """First ``n_bytes`` keystream bytes on the host, numpy uint32 arithmetic
    (which wraps as ChaCha20 wants): the plain version of
    ``hostlib.chacha20_keystream``, where the JAX package's fallback calls
    `cryptography`."""
    n_blocks = -(-n_bytes // 64)
    row = key_table([key], [nonce16])[0]
    counter = (int(row[9]) << 32 | int(row[8])) + np.arange(n_blocks, dtype=np.uint64)
    init = [np.full(n_blocks, c, np.uint32) for c in _CONSTANTS]
    init += [np.full(n_blocks, w, np.uint32) for w in row[:8]]
    init += [(counter & np.uint64(_MASK)).astype(np.uint32),
             (counter >> np.uint64(32)).astype(np.uint32)]
    init += [np.full(n_blocks, w, np.uint32) for w in row[10:]]
    x = list(init)

    def quarter(a, b, c, d):
        x[a] = x[a] + x[b]
        x[d] = _rotl_host(x[d] ^ x[a], 16)
        x[c] = x[c] + x[d]
        x[b] = _rotl_host(x[b] ^ x[c], 12)
        x[a] = x[a] + x[b]
        x[d] = _rotl_host(x[d] ^ x[a], 8)
        x[c] = x[c] + x[d]
        x[b] = _rotl_host(x[b] ^ x[c], 7)

    for _ in range(10):
        for a, b, c, d in _ROUND:
            quarter(a, b, c, d)
    words = np.stack([xi + ii for xi, ii in zip(x, init)], axis=-1)
    return words.astype("<u4").tobytes()[:n_bytes]
