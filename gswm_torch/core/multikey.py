"""Multi-key / multi-message batching: PyTorch port of ``gswm.core.multikey``.

Serving scenario: every image of a batch carries its OWN key, nonce and
message (per-user traceability, 10,000 images and more).  Embed is one
``chacha.batch_embed`` call (on the card ONE launch of the embed kernel
from the table of keys and the packed payloads, copied in one
host-to-device copy, to the latents: no keystream and no cipher bits in
device memory; on the CPU its plain version); decode is one
``chacha.batch_vote`` call (ONE launch of the vote kernel: keystream, XOR
and majority vote, a latent row a key, no keystream in device memory).

Geometry (width, height, l, message_bits) is shared across the batch; mixed
geometries are separate calls.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from gswm_torch.config import GSConfig, prepare_message_bytes
from gswm_torch.core import chacha
from gswm_torch.core.chacha import batch_keystream_bits
from gswm_torch.core.decode import quantize_latent_bits

__all__ = ["batch_keystream_bits", "embed_latents_multikey",
           "recover_message_bits_multikey"]


def embed_latents_multikey(
    cfg: GSConfig,
    keys: Sequence[bytes],
    nonces: Sequence[bytes],
    messages: Sequence[bytes | str],
    generator: Optional[torch.Generator] = None,
    u=None,
    device="cuda",
) -> tuple[torch.Tensor, list[bytes]]:
    """Per-image keys and messages -> ((B, C, h, w) float32 watermarked
    latents on ``device``, the message bytes as embedded).

    ``generator`` (on ``device``) draws the per-element uniforms; ``u`` gives
    them instead, (B, elements), for parity tests.  With neither, fresh
    entropy: a fixed default would repeat u across serving batches and leak
    the watermark's structure (gswm/core/multikey.py:87-93).
    """
    cfg = cfg.resolved()
    b = len(keys)
    if len(nonces) != b or len(messages) != b:
        raise ValueError(f"{b} keys, {len(nonces)} nonces, {len(messages)} messages")
    msg_bytes = [prepare_message_bytes(m, cfg.message_bytes_len, cfg.repeat4)
                 for m in messages]
    table, words = _table_and_payload(keys, nonces, msg_bytes, cfg.capacity_bits, device)
    if u is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(
                int.from_bytes(os.urandom(4), "little"))
        u = torch.rand((b, cfg.total_elements), generator=generator,
                       dtype=torch.float32, device=device)
    else:
        u = torch.as_tensor(u, dtype=torch.float32).to(device).reshape(
            b, cfg.total_elements)
    h, w = cfg.latent_hw
    lat = chacha.batch_embed(table, words, u, cfg.l)
    return lat.reshape(b, cfg.channels, h, w), msg_bytes


def _table_and_payload(keys, nonces, msg_bytes: Sequence[bytes], capacity_bits: int,
                       device):
    """(rows, 12) key table and (rows, ``chacha.block_words``) payload words,
    both views of ONE buffer on ``device``: one host-to-device copy.  A
    row's words are ``bitops.diffuse_payload`` of its message packed as
    ``chacha.pack_bits`` packs bits; a message is whole bytes, so its copies
    tile whole bytes, and the packing is the message bytes repeated, zeros
    after (np.packbits' bytes, viewed as int32 on a little-endian host).  48
    bytes a table row keep the payload 16-byte aligned."""
    rows = len(msg_bytes)
    n_words = chacha.block_words(capacity_bits)
    msgs = np.frombuffer(b"".join(msg_bytes), np.uint8).reshape(rows, -1)
    copies = capacity_bits // (8 * msgs.shape[1])
    packed = np.zeros((rows, 4 * n_words), np.uint8)
    packed[:, :copies * msgs.shape[1]] = np.tile(msgs, (1, copies))
    flat = np.concatenate([chacha.key_table(keys, nonces).view(np.int32).ravel(),
                           packed.view("<i4").ravel()])
    buf = torch.from_numpy(flat).to(device)
    return buf[:12 * rows].view(rows, 12), buf[12 * rows:].view(rows, n_words)


def recover_message_bits_multikey(
    latents: torch.Tensor,
    cfg: GSConfig,
    keys: Sequence[bytes],
    nonces: Sequence[bytes],
) -> torch.Tensor:
    """(B, C, h, w) latents decoded under per-image keys -> (B, message_bits)
    uint8 on the latents' device; one (C, h, w) latent (or B = 1) is decoded
    under every key.  The bits packed once, then one ``chacha.batch_vote``
    call."""
    cfg = cfg.resolved()
    latents = torch.as_tensor(latents)
    bits = quantize_latent_bits(latents, cfg.l)
    n_bits = cfg.capacity_bits
    if bits.shape[-1] != n_bits:
        raise ValueError(f"latents of {bits.shape[-1]} bits for a capacity of {n_bits}")
    table = torch.from_numpy(chacha.key_table(keys, nonces).view(np.int32)).to(latents.device)
    words = chacha.pack_bits(bits.reshape(-1, n_bits), chacha.block_words(n_bits))
    if words.shape[0] not in (1, table.shape[0]):
        raise ValueError(f"{words.shape[0]} latents for {table.shape[0]} keys")
    return chacha.batch_vote(table, words, n_bits, cfg.resolved_message_bits)
