"""Bit-accuracy metric (extract.py:103-110 parity); port of
``gswm.eval.metrics.calculate_bit_accuracy``."""

from __future__ import annotations


def calculate_bit_accuracy(
    original_message_hex: str, extracted_message_bin: str
) -> tuple[str, float]:
    """Exact reference semantics (extract.py:103-110).

    Note the reference quirk, preserved: the original is rendered via
    ``bin(int(hex,16))`` then zfill'ed to 4*len(hex) — identical to a plain
    MSB-first expansion — and both strings are truncated to the shorter one.
    """
    original_message_bin = bin(int(original_message_hex, 16))[2:].zfill(
        len(original_message_hex) * 4
    )
    n = min(len(original_message_bin), len(extracted_message_bin))
    a = original_message_bin[:n]
    b = extracted_message_bin[:n]
    matching = sum(1 for x, y in zip(a, b) if x == y)
    return a, matching / n
