"""Multi-key / multi-message batching: PyTorch port of ``gswm.core.multikey``.

Serving scenario: every image of a batch carries its OWN key, nonce and
message (per-user traceability, 10,000 images and more).  Embed takes the
keystreams of all rows from one call (``chacha.batch_keystream_bits``: on
the card ONE launch of the batch ChaCha20 kernel over a table of keys, on
the CPU its plain version); decode is one ``chacha.batch_vote`` call (ONE
launch of the vote kernel: keystream, XOR and majority vote, a latent row a
key, no keystream in device memory).

Geometry (width, height, l, message_bits) is shared across the batch; mixed
geometries are separate calls.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from gswm_torch.config import GSConfig, prepare_message_bytes
from gswm_torch.core import bits as bitops
from gswm_torch.core import chacha
from gswm_torch.core.chacha import batch_keystream_bits
from gswm_torch.core.decode import quantize_latent_bits
from gswm_torch.core.embed import _bits_to_latent

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
    payload = np.stack([
        bitops.diffuse_payload(bitops.bytes_to_bits(m), cfg.capacity_bits)
        for m in msg_bytes])
    ks = batch_keystream_bits(keys, nonces, cfg.capacity_bits, device)
    cipher = torch.from_numpy(payload).to(device) ^ ks
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
    # the rows share l and the shape, so the single-key map takes the batch
    lat = _bits_to_latent(cipher.reshape(-1), u.reshape(-1), cfg.l,
                          (b, cfg.channels, h, w))
    return lat, msg_bytes


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
