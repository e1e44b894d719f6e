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


def bits_to_bytes(bits: np.ndarray) -> bytes:
    """uint8 bit array (len % 8 == 0) -> bytes, MSB-first per byte."""
    return np.packbits(np.asarray(bits, dtype=np.uint8)).tobytes()


def bits_to_bin_str(bits: np.ndarray) -> str:
    return "".join("1" if b else "0" for b in np.asarray(bits).astype(int))


def bin_str_to_bits(s: str) -> np.ndarray:
    return np.frombuffer(s.encode(), dtype=np.uint8) - ord("0")


def bits_to_hex(bits: np.ndarray) -> str:
    return bits_to_bytes(bits).hex()


def hex_to_bits(h: str) -> np.ndarray:
    """Hex string -> bits, zfill'ed to 4 bits per hex digit
    (extract.py:104 semantics)."""
    if not h:
        return np.zeros(0, dtype=np.uint8)
    # whole bytes unpack at once (a registry of 10,000 records is parsed for
    # every probe); an odd digit count is padded in front and cut again
    raw = bytes.fromhex(h if len(h) % 2 == 0 else "0" + h)
    return np.unpackbits(np.frombuffer(raw, dtype=np.uint8))[-len(h) * 4:]


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
