"""Bit/byte plumbing for the watermark payload.

Host-side helpers operate on the tiny message (<= 128 bytes); everything sized
with the latent (keystream, XOR, windowing) stays on device (see embed.py /
decode.py).

Bit order everywhere is the reference's stream order: bytes in sequence, MSB
first within each byte (``format(byte, '08b')``, gs_insert.py:49), and latent
fill order is C-order over (channels, h, w) (gs_insert.py:65).
"""

from __future__ import annotations

import numpy as np


def bytes_to_bits(data: bytes) -> np.ndarray:
    """Byte string -> uint8 bit array, MSB-first per byte."""
    return np.unpackbits(np.frombuffer(data, dtype=np.uint8))


def bits_to_bin_str(bits: np.ndarray) -> str:
    return "".join("1" if b else "0" for b in np.asarray(bits).astype(int))


def diffuse_payload(message_bits: np.ndarray, capacity_bits: int) -> np.ndarray:
    """Redundancy-code the payload: tile ``repeats`` full copies, zero-fill the
    remainder (gs_insert.py:23 / nodes.py:79-87).

    Returns a uint8 bit array of exactly ``capacity_bits``.
    """
    n = message_bits.shape[0]
    repeats = capacity_bits // n
    out = np.zeros(capacity_bits, dtype=np.uint8)
    out[: repeats * n] = np.tile(message_bits, repeats)
    return out
