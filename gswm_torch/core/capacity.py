"""Watermark capacity policy.

Reproduces the adaptive message-length table of the reference's
resolution-adaptive core (ComfyUI_GSWaterMark/nodes.py:26-49): given the number
of latent elements ("total blocks") pick the largest power-of-two message
length in [32, 1024] bits that still leaves >= 32 redundant repeats.
"""

from __future__ import annotations

_LENGTH_TABLE = (1024, 512, 256, 128, 64)
MIN_REPEATS = 32
MIN_BITS = 32


def choose_watermark_length(total_elements: int) -> int:
    """Largest table entry with >= MIN_REPEATS copies, else 32 bits.

    Matches nodes.py:26-49 exactly (the >=2048-bit rungs are commented out in
    the reference and are likewise not enabled here).
    """
    for bits in _LENGTH_TABLE:
        if total_elements >= bits * MIN_REPEATS:
            return bits
    return MIN_BITS
