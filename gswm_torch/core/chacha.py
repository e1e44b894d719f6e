"""ChaCha20 keystream generation — PyTorch port of ``gswm.core.chacha``.

The reference encrypts the diffused payload with `cryptography`'s ChaCha20,
whose 16-byte "nonce" is ``initial_counter (8B little-endian) || nonce (8B)``
of D. J. Bernstein's original ChaCha20.  The keystream must be bit-identical
to that library's, so every image the reference marked still decodes.

Two implementations, bit-identical:
  * ``keystream_words_reference`` — vectorised torch on int64 tensors that
    emulate uint32 (masking after every add and rotate); any device.
  * the CUDA kernel ``csrc/chacha20.cu`` — one thread per 64-byte block.

``keystream_words`` picks by device: the plain version for the CPU, the
kernel for a CUDA device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gswm_torch import native

_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
_MASK = 0xFFFFFFFF

BLOCK_BITS = 512


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


def keystream_words_reference(key: bytes, nonce16: bytes, n_blocks: int,
                              device="cuda") -> torch.Tensor:
    """Plain version: (n_blocks, 16) int32 words (the uint32 bit pattern)."""
    key_words, counter0, nonce_words = key_nonce_to_words(key, nonce16)
    idx = torch.arange(n_blocks, dtype=torch.int64, device=device)
    lo = (counter0 & _MASK) + idx
    hi = ((counter0 >> 32) + (lo >> 32)) & _MASK  # carry into the high word
    lo = lo & _MASK

    def full(v):
        return torch.full((n_blocks,), int(v), dtype=torch.int64, device=device)

    init = [full(c) for c in _CONSTANTS]
    init += [full(w) for w in key_words.tolist()]
    init += [lo, hi] + [full(w) for w in nonce_words.tolist()]
    x = list(init)
    for _ in range(10):
        _quarter_round(x, 0, 4, 8, 12)
        _quarter_round(x, 1, 5, 9, 13)
        _quarter_round(x, 2, 6, 10, 14)
        _quarter_round(x, 3, 7, 11, 15)
        _quarter_round(x, 0, 5, 10, 15)
        _quarter_round(x, 1, 6, 11, 12)
        _quarter_round(x, 2, 7, 8, 13)
        _quarter_round(x, 3, 4, 9, 14)
    words = torch.stack([(xi + ii) & _MASK for xi, ii in zip(x, init)], dim=-1)
    # reinterpret uint32 as int32: values >= 2^31 wrap to negative
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


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
    lib = native.library()
    with torch.cuda.device(device):
        lib.call("gswm_chacha20_words", ctypes.addressof(words12), out.data_ptr(),
                 n_blocks, native.stream_handle(device))
    keystream_words.launches += 1
    return out


keystream_words.launches = 0


def words_to_bits(words: torch.Tensor) -> torch.Tensor:
    """(n_blocks, 16) words -> (n_blocks*512,) uint8 bits in *stream order*.

    Stream order = bytes little-endian within each word, bits MSB-first within
    each byte — exactly the order of ``''.join(format(byte, '08b') ...)`` over
    the byte stream (gs_insert.py:49).
    """
    j = torch.arange(32, dtype=torch.int64, device=words.device)
    shifts = 8 * (j // 8) + (7 - j % 8)  # (32,)
    w = words.to(torch.int64) & _MASK
    bits = (w[..., None] >> shifts) & 1
    return bits.reshape(words.shape[0] * BLOCK_BITS).to(torch.uint8)


def keystream_bits(key: bytes, nonce16: bytes, n_bits: int,
                   device="cuda") -> torch.Tensor:
    """First ``n_bits`` keystream bits, stream order, on ``device``."""
    n_blocks = -(-n_bits // BLOCK_BITS)
    return words_to_bits(keystream_words(key, nonce16, n_blocks, device))[:n_bits]
