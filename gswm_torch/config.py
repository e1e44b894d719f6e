"""Unified configuration for Gaussian Shading watermarking.

One parameterized config replaces the four drifted embed cores of the reference
(SURVEY.md §2.2): gs_insert.py:8-75 (fixed 64x64), ComfyUI nodes.py:51-138
(arbitrary W/H + adaptive length), and the two A1111 scripts (seed + use_repeat).
Union surface: (width, height, message_bits in {auto, 32..}, l, key, nonce,
seed?, repeat?).

A copy of ``gswm.config``: importing anything under ``gswm`` imports jax, and
the PyTorch port must run where jax is not installed.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from gswm_torch.core.capacity import choose_watermark_length


def resolve_key_nonce(
    key_hex: str = "", nonce_hex: str = ""
) -> tuple[bytes, bytes]:
    """Key/nonce resolution policy of the reference (gs_insert.py:27-42).

    - both given -> use both
    - key only   -> nonce = middle 16 bytes of the key (key_hex[16:48])
    - neither    -> fresh random key (32B) and nonce (16B)
    """
    if key_hex and nonce_hex:
        return bytes.fromhex(key_hex), bytes.fromhex(nonce_hex)
    if key_hex:
        return bytes.fromhex(key_hex), bytes.fromhex(key_hex[16:48])
    return os.urandom(32), os.urandom(16)


def prepare_message_bytes(
    message: str | bytes, message_bytes_len: int, repeat4: bool = False
) -> bytes:
    """Pad / truncate the user message to the watermark payload size.

    Mirrors gs_insert.py:11-20 (pad with NULs to 32B or truncate) generalized to
    any payload size (nodes.py:68-76).  With ``repeat4`` (the A1111
    ``use_repeat`` option, scripts/...higher.py:31-47), the payload is a quarter
    of the size and tiled 4x before diffusion.
    """
    unit = message_bytes_len // 4 if repeat4 else message_bytes_len
    if isinstance(message, str):
        message = message.encode()
    if message:
        if len(message) < unit:
            k = message + b"\x00" * (unit - len(message))
        else:
            k = message[:unit]
    else:
        k = os.urandom(unit)
    return k * 4 if repeat4 else k


@dataclasses.dataclass(frozen=True)
class GSConfig:
    """Everything needed to embed and to extract a Gaussian-Shading watermark.

    Consumed by the library API, the CLIs, and the node/script front-ends — the
    single config replacing the reference's argparse + hardcoded constants
    (SURVEY.md §5 "Config / flag system").
    """

    key_hex: str = ""
    nonce_hex: str = ""
    message: str = ""
    # -1 = auto from capacity table (nodes.py:26-49); else explicit bits.
    message_bits: int = -1
    # window size l: each latent element carries l bits (gs_insert.py:53).
    l: int = 1
    width: int = 512
    height: int = 512
    channels: int = 4  # latent channels (SD family)
    vae_scale: int = 8  # pixels per latent cell
    seed: Optional[int] = None  # None = fresh randomness per call
    repeat4: bool = False  # A1111 "use_repeat": 8-byte message tiled x4

    def __post_init__(self):
        if self.width % self.vae_scale or self.height % self.vae_scale:
            raise ValueError("width/height must be multiples of vae_scale")
        if self.l < 1 or self.l > 8:
            raise ValueError("l must be in [1, 8]")

    # -- derived geometry ---------------------------------------------------
    @property
    def latent_hw(self) -> tuple[int, int]:
        return self.height // self.vae_scale, self.width // self.vae_scale

    @property
    def total_elements(self) -> int:
        h, w = self.latent_hw
        return self.channels * h * w

    @property
    def capacity_bits(self) -> int:
        """Total embeddable bits = elements * l."""
        return self.total_elements * self.l

    @property
    def resolved_message_bits(self) -> int:
        if self.message_bits != -1:
            return self.message_bits
        # The reference's auto table is defined on the element count
        # ("total_blocks_needed", nodes.py:56-64), independent of l.
        return choose_watermark_length(self.total_elements)

    @property
    def message_bytes_len(self) -> int:
        return self.resolved_message_bits // 8

    @property
    def repeats(self) -> int:
        """Full copies of the message that fit (nodes.py:79)."""
        return self.capacity_bits // self.resolved_message_bits

    # -- key material -------------------------------------------------------
    def resolve_key_nonce(self) -> tuple[bytes, bytes]:
        return resolve_key_nonce(self.key_hex, self.nonce_hex)

    def resolved(self) -> "GSConfig":
        """Return a copy with key/nonce/message_bits pinned (no more randomness
        in the *configuration*; the per-image ``u`` stays random)."""
        key, nonce = self.resolve_key_nonce()
        return dataclasses.replace(
            self,
            key_hex=key.hex(),
            nonce_hex=nonce.hex(),
            message_bits=self.resolved_message_bits,
        )
