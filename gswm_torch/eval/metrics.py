"""Bit-accuracy metrics (extract.py:103-110 parity, plus array and batched
variants); port of ``gswm.eval.metrics``."""

from __future__ import annotations

import numpy as np
import torch

from gswm_torch.core import bits as bitops


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


def bit_accuracy_bits(original_bits, extracted_bits) -> float:
    """Array variant: fraction of matching bits over the shorter length."""
    a = np.asarray(original_bits).ravel()
    b = np.asarray(extracted_bits).ravel()
    n = min(a.shape[0], b.shape[0])
    return float(np.mean(a[:n] == b[:n]))


def batched_bit_accuracy(original_bits, extracted_bits) -> torch.Tensor:
    """(B, n) extracted bits against (n,) or (B, n) originals: per-image
    accuracy, float32 (B,), on the extracted bits' device."""
    b = torch.as_tensor(extracted_bits)
    a = torch.as_tensor(original_bits).to(b.device)
    if a.dim() == 1:
        a = a.expand(b.shape)
    return (a == b).to(torch.float32).mean(dim=-1)


def message_hex_to_bits(message_hex: str) -> np.ndarray:
    # the reference's name (gswm/eval/metrics.py); nothing in the port calls it
    return bitops.hex_to_bits(message_hex)
