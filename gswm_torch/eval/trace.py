"""Multi-key traceability: PyTorch port of ``gswm.eval.trace``.

Given a recovered latent Z_T and a registry of (key, nonce, message) records
(info_data.jsonl at 10,000-image scale), find the record that produced the
image.  ``find_source_device`` is the batched path: the latent is quantized
once and, per chunk of candidates, ONE ``batch_keystream_bits`` call (one
launch of the batch ChaCha20 kernel on the card) makes every candidate's
keystream; XOR, majority vote and score are whole-chunk tensor code.
``find_source`` is the host loop, for registries of mixed message lengths:
as gswm/eval/trace.py:17-46 it runs on the native host library
(``gswm_torch.hostlib``, C++ through ctypes), the latent quantized once.
``quantize_bits_host``, ``decode_host`` and ``match_accuracy`` are that
library's plain versions: numpy with the semantics of the JAX package's
host fallbacks (gswm/native/__init__.py:80-122).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from gswm_torch import hostlib
from gswm_torch.core import bits as bitops
from gswm_torch.core import chacha
from gswm_torch.core.decode import majority_vote, quantize_latent_bits


def quantize_bits_host(latents: np.ndarray, l: int = 1) -> np.ndarray:
    """(...,) float latents -> (n * l,) uint8 bits, stream order: the
    float64 normal CDF, floored and clipped to l bits."""
    from scipy.stats import norm

    flat = np.ascontiguousarray(latents, dtype=np.float32).ravel()
    y = np.clip((norm.cdf(flat.astype(np.float64)) * 2**l).astype(np.int64),
                0, 2**l - 1)
    out = np.empty(flat.size * l, dtype=np.uint8)
    for j in range(l):
        out[j::l] = (y >> (l - 1 - j)) & 1
    return out


def decode_host(quant_bits: np.ndarray, key: bytes, nonce16: bytes,
                message_bits: int) -> np.ndarray:
    """Quantized bit stream -> voted message bits: XOR with the keystream,
    then a strict majority over the complete segments, a tie giving 0."""
    qb = np.ascontiguousarray(quant_bits, dtype=np.uint8)
    ks = np.frombuffer(chacha.keystream_bytes_host(key, nonce16, (qb.size + 7) // 8),
                       np.uint8)
    payload = qb ^ np.unpackbits(ks)[: qb.size]
    segs = qb.size // message_bits
    seg = payload[: segs * message_bits].reshape(segs, message_bits)
    return (seg.sum(0) * 2 > segs).astype(np.uint8)


def match_accuracy(voted: np.ndarray, expected: np.ndarray) -> float:
    return float(np.mean(np.asarray(voted, np.uint8) == np.asarray(expected, np.uint8)))


def _message_bits(rec: dict, message_bits: int | None) -> int:
    return int(rec.get("message_length") or message_bits
               or len(rec["message_hex"]) * 4)


def find_source(
    latents,
    candidates: Iterable[dict],
    message_bits: int | None = None,
    l: int = 1,
) -> tuple[int, float, list[float]]:
    """Score every candidate record against one latent, on the host, in
    the native host library (``hostlib``: quantize once, then per candidate
    keystream, XOR, vote and match count in C++).

    candidates: dicts with key_hex / nonce_hex / message_hex (the
    info_data.jsonl schema; message_length optional per record).
    Returns (best_index, best_accuracy, all_accuracies).
    """
    if isinstance(latents, torch.Tensor):
        latents = latents.detach().cpu().numpy()
    qbits = hostlib.quantize_bits(np.asarray(latents, np.float32), l)
    accs = []
    for rec in candidates:
        mb = _message_bits(rec, message_bits)
        if mb <= 0:
            mb = len(rec["message_hex"]) * 4
        voted = hostlib.decode(qbits, bytes.fromhex(rec["key_hex"]),
                               bytes.fromhex(rec["nonce_hex"]), mb)
        accs.append(hostlib.match_accuracy(
            voted, bitops.hex_to_bits(rec["message_hex"])[:mb]))
    best = int(np.argmax(accs))
    return best, accs[best], accs


def find_source_device(
    latents,
    candidates: Iterable[dict],
    message_bits: int | None = None,
    l: int = 1,
    chunk: int = 4096,
    device="cuda",
) -> tuple[int, float, list[float]]:
    """Batched candidate scoring on ``device``: per chunk of ``chunk``
    candidates one ``batch_keystream_bits`` call, XOR against the
    once-quantized latent bits, majority vote, and the mean agreement with
    the expected message bits.  No per-candidate host loop.

    Candidates must share message_bits (the registry's serving shape); use
    ``find_source`` for registries of mixed lengths.  Same return contract.
    """
    cands = list(candidates)
    mbs = {_message_bits(rec, message_bits) for rec in cands}
    if len(mbs) != 1:
        raise ValueError(
            f"find_source_device needs uniform message_bits, got {sorted(mbs)}")
    mb = mbs.pop()
    device = torch.device(device)
    z = torch.as_tensor(latents).to(device, torch.float32)
    qbits = quantize_latent_bits(z, l)
    n_bits = int(qbits.shape[-1])

    accs: list[float] = []
    for start in range(0, len(cands), chunk):
        batch = cands[start:start + chunk]
        keys = [bytes.fromhex(r["key_hex"]) for r in batch]
        nonces = [bytes.fromhex(r["nonce_hex"]) for r in batch]
        expected = torch.from_numpy(np.stack(
            [bitops.hex_to_bits(r["message_hex"])[:mb] for r in batch])).to(device)
        ks = chacha.batch_keystream_bits(keys, nonces, n_bits, device)
        voted = majority_vote(ks.bitwise_xor_(qbits), mb)
        accs.extend((voted == expected).to(torch.float32).mean(dim=-1).tolist())
    best = int(np.argmax(accs))
    return best, accs[best], accs
