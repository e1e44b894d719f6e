"""Watermark extraction: inverted latent Z_T -> message bits.

PyTorch port of ``gswm.core.decode``.  Semantics preserved exactly:
  * quantize: y = floor(ndtr(z) * 2^l), clipped to 2^l - 1 (the reference's
    ``int(norm.cdf(z) * 2**l)``; for l=1 this is the sign test z >= 0).
  * decrypt:  XOR with the same ChaCha20 keystream (stream order).
  * vote:     per-bit-position strict majority over the redundant copies —
    count_1 > n_segments/2, ties -> 0 (extract.py:97-99).  Only complete
    segments vote; the zero-filled remainder (if any) is excluded.
"""

from __future__ import annotations

from typing import Optional

import torch

from gswm_torch.config import GSConfig
from gswm_torch.core import bits as bitops
from gswm_torch.core import chacha
from gswm_torch.utils.profiling import span


def quantize_latent_bits(latents: torch.Tensor, l: int) -> torch.Tensor:
    """(..., C, h, w) latents -> (..., elements*l) uint8 bits, stream order."""
    z = latents.to(torch.float32)
    flat = z.reshape(z.shape[:-3] + (-1,))  # C-order, matches embed fill
    y = torch.floor(torch.special.ndtr(flat) * (2.0**l))
    y = torch.clamp(y, 0, 2**l - 1).to(torch.uint8)
    if l == 1:
        return y
    shifts = torch.arange(l - 1, -1, -1, dtype=torch.uint8, device=y.device)
    bits = (y[..., None] >> shifts) & 1
    return bits.reshape(bits.shape[:-2] + (-1,))


def majority_vote(payload_bits: torch.Tensor, message_bits: int) -> torch.Tensor:
    """(..., capacity_bits) decrypted bits -> (..., message_bits) voted bits."""
    cap = payload_bits.shape[-1]
    segments = cap // message_bits
    segs = payload_bits[..., : segments * message_bits].reshape(
        payload_bits.shape[:-1] + (segments, message_bits))
    count_1 = segs.to(torch.int32).sum(dim=-2)
    # strict majority, tie -> 0 (extract.py:99)
    return (count_1 * 2 > segments).to(torch.uint8)


def _decode_chain(latents: torch.Tensor, keystream: torch.Tensor, l: int,
                  message_bits: int) -> torch.Tensor:
    """quantize + XOR-decrypt + majority vote."""
    payload = quantize_latent_bits(latents, l) ^ keystream
    return majority_vote(payload, message_bits)


def recover_message_bits(latents: torch.Tensor, cfg: GSConfig,
                         keystream: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full decode chain on the latents' device. latents: (B, C, h, w) or
    (C, h, w).  Returns voted message bits of shape (..., message_bits) as
    uint8.  The keystream, unless given, is the cached one of (key, nonce,
    capacity, device), shared with embed."""
    with span("gswm.decode_bits"):
        cfg = cfg.resolved()
        latents = torch.as_tensor(latents)
        if keystream is None:
            key, nonce = cfg.resolve_key_nonce()
            keystream = chacha.cached_keystream_bits(key, nonce, cfg.capacity_bits,
                                                     latents.device)
        return _decode_chain(latents, keystream, cfg.l, cfg.resolved_message_bits)


def decode_latents(latents: torch.Tensor, cfg: GSConfig) -> str | list[str]:
    """Decode to binary string(s) — the reference's return type
    (extract.py:95-101)."""
    voted = recover_message_bits(latents, cfg).cpu().numpy()
    if voted.ndim == 1:
        return bitops.bits_to_bin_str(voted)
    return [bitops.bits_to_bin_str(v) for v in voted]
