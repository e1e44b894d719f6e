"""Watermark embed: message -> encrypted bits -> Gaussian latent Z_T.

PyTorch port of ``gswm.core.embed``.  The map per latent element is

    z = ndtri((u + y) / 2**l)

with ``y`` the l-bit window of the ChaCha20-encrypted payload and
``u ~ U(0,1)``.  For y uniform on [0, 2^l) and u uniform on [0,1), (u+y)/2^l
is uniform on [0,1), so z is exactly N(0,1): the paper's
"performance-lossless" property.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import torch

from gswm_torch.config import GSConfig, prepare_message_bytes
from gswm_torch.core import bits as bitops
from gswm_torch.core import chacha


def _bits_to_latent(cipher_bits: torch.Tensor, u: torch.Tensor, l: int,
                    shape) -> torch.Tensor:
    """cipher_bits: (capacity_bits,) uint8; u: (elements,) float32 in [0,1).

    Windows the bit stream into l-bit big-endian integers y (gs_insert.py:58-60)
    and applies the inverse-CDF map, reshaping C-order into ``shape``.
    """
    elements = u.shape[-1]
    w = cipher_bits.reshape(elements, l).to(torch.float32)
    powers = 2.0 ** torch.arange(l - 1, -1, -1, dtype=torch.float32,
                                 device=w.device)
    y = w @ powers if l > 1 else w[:, 0]
    p = (u + y) * (0.5**l)
    # keep p strictly inside (0,1) so ndtri stays finite (embed.py:43-45)
    p = torch.clamp(p, 1e-7, 1.0 - 1e-7)
    return torch.special.ndtri(p).reshape(u.shape[:-1] + tuple(shape))


def encrypted_payload_bits(cfg: GSConfig, message_bytes: bytes,
                           device="cuda") -> torch.Tensor:
    """Diffused payload XOR keystream: (capacity_bits,) uint8 on ``device``.

    Equivalent to ChaCha20-encrypting the tiled message byte-stream
    (gs_insert.py:45-47): XOR in the bit domain commutes with the byte<->bit
    packing because both use the same stream order.  Kept per (key, nonce,
    message, capacity, device), so repeated embeds run no keystream and copy
    nothing to the device; the tensor is shared: read it, never write into it.
    """
    key, nonce = cfg.resolve_key_nonce()
    return _cached_payload_bits(key, nonce, message_bytes, cfg.capacity_bits,
                                chacha.canonical_device(device))


@functools.lru_cache(maxsize=32)
def _cached_payload_bits(key: bytes, nonce: bytes, message_bytes: bytes,
                         capacity_bits: int, device: torch.device) -> torch.Tensor:
    """gswm/core/embed.py:61-71; the keystream comes from the cache that
    decode shares."""
    payload = bitops.diffuse_payload(bitops.bytes_to_bits(message_bytes), capacity_bits)
    ks = chacha.cached_keystream_bits(key, nonce, capacity_bits, device)
    return torch.from_numpy(payload).to(device) ^ ks


def clear_caches() -> None:
    """Forget every cached payload and keystream."""
    _cached_payload_bits.cache_clear()
    chacha.clear_caches()


def embed_latents(
    cfg: GSConfig,
    generator: Optional[torch.Generator] = None,
    batch: int = 1,
    message_bytes: Optional[bytes] = None,
    u=None,
    replicate: Optional[bool] = None,
    device="cuda",
) -> tuple[torch.Tensor, bytes]:
    """Synthesize watermarked init noise Z_T.

    Returns ``(latents, message_bytes)`` with latents of shape
    (batch, channels, H/8, W/8), float32 on ``device``, marginally N(0,1).
    ``device`` defaults to the card; the CPU is asked for by name.

    - ``generator``: torch.Generator (on ``device``) for the per-element
      uniforms.  Defaults to one seeded with ``cfg.seed``, or fresh entropy
      when unseeded.
    - ``u``: explicit uniforms (n_draws, elements), tensor or numpy, for
      golden-parity tests.
    - ``replicate``: seeded ComfyUI semantics — one latent replicated across
      the batch when seeded, independent latents otherwise (nodes.py:232-238).
      Default: replicate iff cfg.seed is not None.
    """
    cfg = cfg.resolved()
    if message_bytes is None:
        message_bytes = prepare_message_bytes(
            cfg.message, cfg.message_bytes_len, cfg.repeat4)
    cipher_bits = encrypted_payload_bits(cfg, message_bytes, device)

    if replicate is None:
        replicate = cfg.seed is not None
    n_draws = 1 if replicate else batch
    h, w = cfg.latent_hw
    shape = (cfg.channels, h, w)

    if u is None:
        if generator is None:
            # unseeded: fresh entropy — a fixed default would replicate u
            # across runs and leak the watermark pattern.
            seed = (cfg.seed if cfg.seed is not None
                    else int.from_bytes(os.urandom(4), "little"))
            generator = torch.Generator(device=device).manual_seed(seed)
        u = torch.rand((n_draws, cfg.total_elements), generator=generator,
                       dtype=torch.float32, device=device)
    else:
        u = torch.as_tensor(u, dtype=torch.float32).to(device)
        u = u.reshape(n_draws, cfg.total_elements)
    lat = _bits_to_latent(cipher_bits, u, cfg.l, shape)
    if replicate and batch > 1:
        lat = lat.expand((batch,) + lat.shape[1:])
    return lat, message_bytes
