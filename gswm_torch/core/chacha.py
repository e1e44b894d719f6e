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
  * ``batch_vote`` / ``batch_vote_reference`` — a table of keys against
    packed latent bits (``pack_bits``): XOR, majority vote and, given the
    expected message, the score, in ONE launch of the vote kernel that
    writes no keystream (attribution and the per-row decode); rows past
    ``VOTE_MAX_BLOCKS`` blocks in its stream mode (``vote_entry``).
  * ``batch_embed`` / ``batch_embed_reference`` — a table of keys, each
    row's diffused payload packed the same way and its uniforms: keystream,
    XOR, the l-bit windows and the inverse-CDF map to the latent in ONE
    launch of the embed kernel (the multikey embed).
  * ``keystream_bytes_host`` — numpy on uint32: the plain version of the
    host loop's keystream (``eval.trace.decode_host``), which
    ``eval.trace.find_source`` runs in ``hostlib``'s C++.

``keystream_words``, ``batch_keystream_bits``, ``batch_vote`` and
``batch_embed`` pick by device: the plain version for the CPU, the kernel for a CUDA device.
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

# rows of at most this many ChaCha20 blocks (1,835,008 bits): the vote
# kernel keeps a row's payload words in shared memory, 224 KB; longer rows
# go to its stream mode, which makes them a chunk at a time
VOTE_MAX_BLOCKS = 3584
VOTE_ENTRY = "gswm_chacha20_vote"
VOTE_STREAM_ENTRY = "gswm_chacha20_vote_stream"


# the stream mode's split: a row over a cluster of at most this many thread
# blocks, each counting the windows of an equal share of the row's stream
# (csrc/chacha20.cu STREAM_MAX_SPLITS)
VOTE_MAX_SPLITS = 8


def vote_entry(n_bits: int) -> str:
    """The C entry ``batch_vote`` calls for rows of ``n_bits`` bits: the
    vote kernel's warp and block modes to ``VOTE_MAX_BLOCKS`` blocks, its
    stream mode past them (csrc/chacha20.cu chacha20_vote_stream_kernel)."""
    return VOTE_ENTRY if -(-n_bits // BLOCK_BITS) <= VOTE_MAX_BLOCKS else VOTE_STREAM_ENTRY


def vote_splits(rows: int, sms: int) -> int:
    """Thread blocks a row of the stream mode for ``rows`` rows on a card of
    ``sms`` SMs: the largest power of two to ``VOTE_MAX_SPLITS`` that keeps
    rows * splits within the SM count, 1 (a block a row) past ``sms / 2``
    rows.  A block makes its ChaCha20 blocks in turn, so a second block
    on an SM adds little; the card timed that rule best (PERF.md)."""
    splits = 1
    while splits < VOTE_MAX_SPLITS and rows * splits * 2 <= sms:
        splits *= 2
    return splits


@functools.lru_cache(maxsize=None)
def _multiprocessors(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _byte_shifts(device) -> torch.Tensor:
    """A packed byte's bit positions, most significant first (stream
    order), made on ``device`` (no host-to-device copy)."""
    return torch.arange(7, -1, -1, dtype=torch.uint8, device=device)


def block_words(n_bits: int) -> int:
    """Words of a latent row packed for ``batch_vote``: whole 512-bit
    blocks."""
    return -(-n_bits // BLOCK_BITS) * 16


def pack_bits(bits: torch.Tensor, n_words: int) -> torch.Tensor:
    """(..., n) 0/1 bits in stream order -> (..., n_words) int32 words on
    the bits' device, zero-filled past n: stream bit i is bit (i % 32) ^ 7
    of word i // 32 (bytes little-endian in a word, bits MSB-first in a
    byte), the order of the keystream's own words, so one XOR decrypts 32
    bits.  The words are the bytes of ``np.packbits`` viewed as int32 on a
    little-endian host, which every platform of PyTorch is."""
    n = bits.shape[-1]
    if n > 32 * n_words:
        raise ValueError(f"pack_bits: {n} bits do not fit {n_words} words")
    b = bits.to(torch.uint8)
    if n < 32 * n_words:  # a pad of nothing would still copy
        b = torch.nn.functional.pad(b, (0, 32 * n_words - n))
    packed = (b.reshape(b.shape[:-1] + (4 * n_words, 8)) << _byte_shifts(b.device)).sum(
        -1, dtype=torch.uint8)
    return packed.view(torch.int32)


def unpack_bits(words: torch.Tensor, n_bits: int) -> torch.Tensor:
    """``pack_bits``'s inverse: (..., W) int32 words -> (..., n_bits) uint8."""
    bits = (words.contiguous().view(torch.uint8)[..., None] >> _byte_shifts(words.device)) & 1
    return bits.reshape(words.shape[:-1] + (-1,))[..., :n_bits]


def _inverse(mb: int) -> float:
    """fl(1 / mb) in float32: the JAX package's jitted mean of mb values is
    their sum times it (XLA folds the division by a constant into a
    multiplication by its reciprocal)."""
    return float(np.float32(1) / np.float32(mb))


def batch_vote_reference(table: torch.Tensor, latent_words: torch.Tensor, n_bits: int,
                         message_bits: int, expected: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Plain version of ``batch_vote``: the int64 emulation's keystream
    words, XOR, unpacked to bits, ``majority_vote`` and, with ``expected``,
    the share of voted bits equal to it as the JAX package's mean computes
    it."""
    from gswm_torch.core.decode import majority_vote

    n_blocks = -(-n_bits // BLOCK_BITS)
    ks = _table_words_reference(table.to(torch.int64) & _MASK, n_blocks)
    payload = unpack_bits(ks.reshape(ks.shape[0], -1) ^ latent_words, n_bits)
    voted = majority_vote(payload, message_bits)
    if expected is None:
        return voted
    matches = (voted == unpack_bits(expected, message_bits)).sum(-1).to(torch.float32)
    return matches * torch.full_like(matches, _inverse(message_bits))


def batch_vote(table: torch.Tensor, latent_words: torch.Tensor, n_bits: int,
               message_bits: int, expected: torch.Tensor | None = None) -> torch.Tensor:
    """R keystreams against packed latent bits, voted: ``table`` (R, 12)
    int32 rows of key[8], counter lo, counter hi, nonce[2] (``key_table``'s
    words); ``latent_words`` (1 or R, ``block_words(n_bits)``) int32 from
    ``pack_bits``, one latent for every row or one a row; with ``expected``
    (R, ceil(message_bits / 32)) int32 packed the same way, the (R,)
    float32 share of voted bits equal to it, else the (R, message_bits)
    uint8 voted bits.  ``(quantized ^ keystream)`` majority-voted over the
    complete segments, a tie giving 0, as ``gswm.eval.trace.
    find_source_device``'s score and ``gswm.core.multikey.
    recover_message_bits_multikey`` compute it.  CPU: the plain version.
    CUDA: ONE launch of the vote kernel, which writes no keystream, at any
    row length with rows * blocks < 2^31 (``vote_entry``'s mode; in the
    stream mode ``vote_splits`` blocks a row)."""
    device = table.device
    rows = table.shape[0]
    ew = -(-message_bits // 32)
    if table.dtype != torch.int32 or table.shape != (rows, 12) or rows < 1:
        raise ValueError(f"batch_vote: table {tuple(table.shape)} {table.dtype}, "
                         "want (R, 12) int32")
    if latent_words.dtype != torch.int32 or latent_words.shape[0] not in (1, rows) \
            or latent_words.shape[1:] != (block_words(n_bits),):
        raise ValueError(f"batch_vote: latent words {tuple(latent_words.shape)} "
                         f"{latent_words.dtype}, want (1 or {rows}, "
                         f"{block_words(n_bits)}) int32")
    if expected is not None and (expected.dtype != torch.int32
                                 or expected.shape != (rows, ew)):
        raise ValueError(f"batch_vote: expected {tuple(expected.shape)} {expected.dtype}, "
                         f"want ({rows}, {ew}) int32")
    if n_bits < 1 or not 1 <= message_bits < 2**24:
        raise ValueError(f"batch_vote: {n_bits} bits, {message_bits} message bits")
    if any(t.device != device for t in (latent_words, expected) if t is not None):
        raise ValueError("batch_vote: the tensors lie on different devices")
    if device.type == "cpu":
        return batch_vote_reference(table, latent_words, n_bits, message_bits, expected)
    if device.type != "cuda":
        raise ValueError(f"batch_vote: unsupported device {device}")
    if rows * -(-n_bits // BLOCK_BITS) >= 2**31:
        raise ValueError(f"batch_vote: {rows} rows of {n_bits} bits out of range")
    if not all(t.is_contiguous() for t in (table, latent_words, expected) if t is not None) \
            or latent_words.data_ptr() % 16:
        raise ValueError("batch_vote: the tensors must be contiguous, the latent words "
                         "16-byte aligned")
    if expected is None:
        scores = None
        out = voted = torch.empty((rows, message_bits), dtype=torch.uint8, device=device)
    else:
        voted = None
        out = scores = torch.empty(rows, dtype=torch.float32, device=device)
    entry = vote_entry(n_bits)
    split = (vote_splits(rows, _multiprocessors(device)),) if entry == VOTE_STREAM_ENTRY \
        else ()
    native.launch(device, entry, table.data_ptr(), latent_words.data_ptr(),
                  latent_words.shape[0], None if expected is None else expected.data_ptr(),
                  None if scores is None else scores.data_ptr(),
                  None if voted is None else voted.data_ptr(), rows, n_bits, message_bits,
                  *split)
    batch_vote.launches += 1
    batch_vote.stream_launches += entry == VOTE_STREAM_ENTRY
    return out


batch_vote.launches = 0
batch_vote.stream_launches = 0  # of them, the stream mode's (rows past VOTE_MAX_BLOCKS)


def batch_embed_reference(table: torch.Tensor, payload_words: torch.Tensor, u: torch.Tensor,
                          l: int) -> torch.Tensor:
    """Plain version of ``batch_embed``: the int64 emulation's keystream
    words XOR the payload words, unpacked to bits, then the l-bit windows,
    the clamp and ndtri as ``embed._bits_to_latent`` rounds them."""
    from gswm_torch.core.embed import _bits_to_latent

    elements = u.shape[-1]
    n_blocks = -(-elements * l // BLOCK_BITS)
    ks = _table_words_reference(table.to(torch.int64) & _MASK, n_blocks)
    bits = unpack_bits(ks.reshape(ks.shape[0], -1) ^ payload_words, elements * l)
    return _bits_to_latent(bits.reshape(-1), u.reshape(-1), l, tuple(u.shape))


def batch_embed(table: torch.Tensor, payload_words: torch.Tensor, u: torch.Tensor,
                l: int) -> torch.Tensor:
    """R rows of (key, nonce) and payload -> (R, elements) float32 latents:
    ``table`` (R, 12) int32 rows of ``key_table``'s words; ``payload_words``
    (R, ``block_words(elements * l)``) int32, each row's diffused payload
    bits packed by ``pack_bits``; ``u`` (R, elements) float32 uniforms.
    z = ndtri(clamp((u + y) 2^-l, 1e-7, 1 - 1e-7)) with y the l-bit
    big-endian windows of payload XOR keystream, as
    ``gswm.core.multikey.embed_latents_multikey`` maps its cipher bits.  CPU:
    the plain version.  CUDA: ONE launch of the embed kernel, which writes
    no keystream and no cipher bits; ``table`` and ``payload_words`` may be
    views of one buffer (one host-to-device copy)."""
    device = u.device
    rows = table.shape[0]
    if table.dtype != torch.int32 or table.shape != (rows, 12) or rows < 1:
        raise ValueError(f"batch_embed: table {tuple(table.shape)} {table.dtype}, "
                         "want (R, 12) int32")
    if not 1 <= l <= 8 or u.dtype != torch.float32 or u.dim() != 2 or u.shape[0] != rows:
        raise ValueError(f"batch_embed: u {tuple(u.shape)} {u.dtype} at l = {l}, want "
                         f"({rows}, elements) float32 and 1 <= l <= 8")
    elements = u.shape[1]
    words = block_words(elements * l)
    if payload_words.dtype != torch.int32 or payload_words.shape != (rows, words):
        raise ValueError(f"batch_embed: payload words {tuple(payload_words.shape)} "
                         f"{payload_words.dtype}, want ({rows}, {words}) int32")
    if table.device != device or payload_words.device != device:
        raise ValueError("batch_embed: the tensors lie on different devices")
    if device.type == "cpu":
        return batch_embed_reference(table, payload_words, u, l)
    if device.type != "cuda":
        raise ValueError(f"batch_embed: unsupported device {device}")
    if rows * (words // 16) >= 2**31:
        raise ValueError(f"batch_embed: {rows} rows of {elements * l} bits out of range")
    if not all(t.is_contiguous() for t in (table, payload_words, u)) \
            or payload_words.data_ptr() % 16 or u.data_ptr() % 16:
        raise ValueError("batch_embed: the tensors must be contiguous, the payload words "
                         "and u 16-byte aligned")
    z = torch.empty_like(u)
    native.launch(device, "gswm_chacha20_embed", table.data_ptr(), payload_words.data_ptr(),
                  u.data_ptr(), z.data_ptr(), rows, elements, l)
    batch_embed.launches += 1
    return z


batch_embed.launches = 0


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
