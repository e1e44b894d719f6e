"""Gaussian Shading's watermark in plain PyTorch: ChaCha20 (D. J.
Bernstein's original, the 16-byte "nonce" of the `cryptography` package
being an 8-byte little-endian counter then an 8-byte nonce), the embed
z = ndtri((u + y) / 2^l) and the extraction's quantize, decrypt and
strict-majority vote.

Bits run in stream order: bytes in sequence, most significant bit first,
latent elements in C order over (channels, h, w).
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
ROUND = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
         (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14))


def _rotl(x, n):
    return ((x << n) | (x >> (32 - n))) & MASK


def keystream_bits(key: bytes, nonce16: bytes, n_bits: int, device="cpu") -> torch.Tensor:
    """The first ``n_bits`` keystream bits, (n_bits,) uint8, in stream order;
    uint32 arithmetic on int64 tensors, every block at once."""
    if len(key) != 32 or len(nonce16) != 16:
        raise ValueError("ChaCha20 takes a 32-byte key and a 16-byte nonce")
    kw = np.frombuffer(key, dtype="<u4").astype(np.int64).tolist()
    counter = int.from_bytes(nonce16[:8], "little")
    nw = np.frombuffer(nonce16[8:], dtype="<u4").astype(np.int64).tolist()
    blocks = -(-n_bits // 512)
    lo = (counter & MASK) + torch.arange(blocks, dtype=torch.int64, device=device)
    hi = ((counter >> 32) + (lo >> 32)) & MASK  # the carry into the high word
    lo = lo & MASK
    init = [torch.full_like(lo, c) for c in CONSTANTS] + [torch.full_like(lo, w) for w in kw]
    init += [lo, hi] + [torch.full_like(lo, w) for w in nw]
    x = list(init)
    for _ in range(10):
        for a, b, c, d in ROUND:
            x[a] = (x[a] + x[b]) & MASK
            x[d] = _rotl(x[d] ^ x[a], 16)
            x[c] = (x[c] + x[d]) & MASK
            x[b] = _rotl(x[b] ^ x[c], 12)
            x[a] = (x[a] + x[b]) & MASK
            x[d] = _rotl(x[d] ^ x[a], 8)
            x[c] = (x[c] + x[d]) & MASK
            x[b] = _rotl(x[b] ^ x[c], 7)
    words = torch.stack([(xi + ii) & MASK for xi, ii in zip(x, init)], dim=-1)
    # little-endian bytes of each word, most significant bit first in a byte
    j = torch.arange(32, device=device)
    bits = (words[..., None] >> (8 * (j // 8) + 7 - j % 8)) & 1
    return bits.reshape(-1)[:n_bits].to(torch.uint8)


def payload_bits(message: bytes, capacity: int, device="cpu") -> torch.Tensor:
    """The message's bits tiled over ``capacity`` bits, the remainder zero."""
    m = torch.from_numpy(np.unpackbits(np.frombuffer(message, dtype=np.uint8)))
    reps = capacity // m.numel()
    out = torch.zeros(capacity, dtype=torch.uint8)
    out[: reps * m.numel()] = m.repeat(reps)
    return out.to(device)


def embed(u: torch.Tensor, cipher: torch.Tensor, l: int, shape) -> torch.Tensor:
    """(B, elements) float32 uniforms and the (elements * l,) cipher bits ->
    float64 latents (B, *shape): p = (u + y) / 2^l in float32, as the
    watermark defines it, kept within (1e-7, 1 - 1e-7), then ndtri in
    float64."""
    w = cipher.reshape(-1, l).to(torch.float32)
    y = w @ (2.0 ** torch.arange(l - 1, -1, -1, dtype=torch.float32, device=w.device))
    p = torch.clamp((u.float() + y) * (0.5 ** l), 1e-7, 1.0 - 1e-7)
    return torch.special.ndtri(p.double()).reshape((u.shape[0],) + tuple(shape))


def extract(z: torch.Tensor, keystream: torch.Tensor, l: int, message_bits: int) -> torch.Tensor:
    """(B, C, h, w) latents -> (B, message_bits) voted bits: y = floor(ndtr(z)
    2^l) in float32 (the reference's int(norm.cdf(z) * 2**l)), its l bits
    XOR the keystream, then a strict majority over the complete copies, ties
    to 0."""
    y = torch.floor(torch.special.ndtr(z.float().reshape(z.shape[0], -1)) * 2.0 ** l)
    y = torch.clamp(y, 0, 2 ** l - 1).to(torch.int64)
    bits = (y[..., None] >> torch.arange(l - 1, -1, -1, device=z.device)) & 1
    bits = bits.reshape(z.shape[0], -1).to(torch.uint8) ^ keystream
    segs = bits.shape[1] // message_bits
    count = bits[:, : segs * message_bits].reshape(-1, segs, message_bits).sum(dim=1)
    return (count * 2 > segs).to(torch.uint8)
