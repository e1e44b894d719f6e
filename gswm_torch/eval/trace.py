"""Multi-key traceability: PyTorch port of ``gswm.eval.trace``.

Given a recovered latent Z_T and a registry of (key, nonce, message) records
(info_data.jsonl at 10,000-image scale), find the record that produced the
image.  ``find_source_device`` is the batched path: the latent is quantized
and packed once and, per chunk of candidates, ONE ``chacha.batch_vote``
call (one launch of the vote kernel on the card) makes every candidate's
keystream, XORs it, votes and scores, with no keystream in device memory.
``pack_candidates`` parses a registry into the key table and the packed
expected bits once, so a caller that probes many latents against one
registry (``cli.gs_trace``) pays the parse once.
``find_source`` is the host loop, for registries of mixed message lengths:
as gswm/eval/trace.py:17-46 it runs on the native host library
(``gswm_torch.hostlib``, C++ through ctypes), the latent quantized once.
``quantize_bits_host``, ``decode_host`` and ``match_accuracy`` are that
library's plain versions: numpy with the semantics of the JAX package's
host fallbacks (gswm/native/__init__.py:80-122).
"""

from __future__ import annotations

from dataclasses import dataclass
from operator import itemgetter
from typing import Iterable

import numpy as np
import torch

from gswm_torch import hostlib
from gswm_torch.core import bits as bitops
from gswm_torch.core import chacha
from gswm_torch.core.decode import quantize_latent_bits


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


@dataclass(frozen=True)
class PackedCandidates:
    """A registry packed for ``find_source_device``: ``table`` (R, 12) int32
    rows of key[8], counter lo, counter hi, nonce[2] (``chacha.key_table``)
    and ``expected`` (R, ceil(message_bits / 32)) int32, each record's first
    ``message_bits`` message bits packed in stream order
    (``chacha.pack_bits``, zero past them), both on one device."""

    table: torch.Tensor
    expected: torch.Tensor
    message_bits: int

    def __len__(self) -> int:
        return self.table.shape[0]


def _hex_rows(hexes: list, n_bytes: int, what: str) -> np.ndarray:
    """Equal-length hex strings -> (len, n_bytes) uint8, one ``bytes.fromhex``
    over their join."""
    if set(map(len, hexes)) != {2 * n_bytes}:
        raise ValueError(what)
    raw = bytes.fromhex("".join(hexes))
    if len(raw) != n_bytes * len(hexes):  # whitespace inside a string
        raise ValueError(what)
    return np.frombuffer(raw, np.uint8).reshape(len(hexes), n_bytes)


def pack_candidates(candidates: Iterable[dict], message_bits: int | None = None,
                    device="cuda") -> PackedCandidates:
    """The records (key_hex / nonce_hex / message_hex, message_length
    optional) as ``find_source_device`` scores them, on ``device``.  Each
    field is parsed by one ``bytes.fromhex`` over the records' joined hex
    strings.  Raises ValueError where the per-record parse raises: message
    lengths that differ (``find_source`` takes those), keys or nonces not 32
    and 16 bytes, a message of fewer bits than its length."""
    cands = list(candidates)
    if not cands:
        raise ValueError("pack_candidates: no records")
    mbs = {_message_bits(rec, message_bits) for rec in cands}
    if len(mbs) != 1:
        raise ValueError(
            f"find_source_device needs uniform message_bits, got {sorted(mbs)}")
    mb = mbs.pop()
    if mb < 1:
        raise ValueError(f"pack_candidates: {mb} message bits")
    bad_key = "ChaCha20 needs 32-byte keys and 16-byte nonces"
    keys = _hex_rows(list(map(itemgetter("key_hex"), cands)), 32, bad_key)
    nonces = _hex_rows(list(map(itemgetter("nonce_hex"), cands)), 16, bad_key)
    table = np.concatenate([keys, nonces], axis=1).view("<i4")
    # hex_to_bits: 4 bits a digit, so the first mb bits are the first
    # ceil(mb / 4) digits', a digit of 0 making the last byte whole
    digits = -(-mb // 4)
    msgs = list(map(itemgetter("message_hex"), cands))
    lengths = set(map(len, msgs))
    if min(lengths) < digits:
        raise ValueError(f"pack_candidates: a message holds fewer than {mb} bits")
    if lengths != {digits} or digits % 2:
        tail = "0" * (digits % 2)
        msgs = [h[:digits] + tail for h in msgs]
    raw = _hex_rows(msgs, -(-digits // 2), "pack_candidates: a message is not hex")
    ew = -(-mb // 32)
    words = np.zeros((len(cands), 4 * ew), np.uint8)
    words[:, :raw.shape[1]] = raw
    if mb % 8:  # zero past the message's last bit
        words[:, mb // 8] &= np.uint8(0xFF << (8 - mb % 8) & 0xFF)
    return PackedCandidates(torch.from_numpy(np.ascontiguousarray(table)).to(device),
                            torch.from_numpy(words.view("<i4")).to(device), mb)


def find_source_device(
    latents,
    candidates,
    message_bits: int | None = None,
    l: int = 1,
    chunk: int = 4096,
    device="cuda",
) -> tuple[int, float, list[float]]:
    """Batched candidate scoring on ``device``: the latent quantized and
    packed once, then per chunk of ``chunk`` candidates one
    ``chacha.batch_vote`` call (keystream, XOR against the latent's bits,
    majority vote and the mean agreement with the expected message bits:
    one launch on the card).  No per-candidate host loop.

    ``candidates``: the records, as ``find_source`` takes them, or
    ``pack_candidates``' result (``message_bits`` was applied when packing
    and is not read again).  Records must share message_bits (the
    registry's serving shape); use ``find_source`` for registries of mixed
    lengths.  Same return contract.
    """
    device = torch.device(device)
    packed = candidates if isinstance(candidates, PackedCandidates) \
        else pack_candidates(candidates, message_bits, device)
    z = torch.as_tensor(latents).to(device, torch.float32)
    qbits = quantize_latent_bits(z, l)
    if qbits.dim() > 1 and qbits.shape[:-1].numel() != 1:
        raise ValueError(f"find_source_device: one latent, got {tuple(z.shape)}")
    n_bits = int(qbits.shape[-1])
    words = chacha.pack_bits(qbits.reshape(1, n_bits), chacha.block_words(n_bits))
    table, expected = packed.table.to(device), packed.expected.to(device)
    mb = packed.message_bits
    scores = torch.cat([chacha.batch_vote(table[start:start + chunk], words, n_bits, mb,
                                          expected[start:start + chunk])
                        for start in range(0, len(packed), chunk)]).cpu().numpy()
    best = int(np.argmax(scores))
    accs = scores.tolist()
    return best, accs[best], accs
