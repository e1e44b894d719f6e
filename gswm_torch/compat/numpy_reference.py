"""Golden NumPy re-derivation of the reference embed/decode semantics (a
copy of ``gswm.compat.numpy_reference``).

This module intentionally follows the *specification* extracted in SURVEY.md
(gs_insert.py:8-75, nodes.py:51-138, extract.py:72-101) element-by-element —
including scalar per-element processing — so the vectorized core can be
tested bit-for-bit against it.  It is a test oracle on the CPU, never a
production path: ``cryptography`` and ``scipy.stats`` are imported inside the
functions, so the module imports where neither is installed.
"""

from __future__ import annotations

import numpy as np


def _chacha_encrypt(key: bytes, nonce16: bytes, data: bytes) -> bytes:
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms

    cipher = Cipher(algorithms.ChaCha20(key, nonce16), mode=None)
    enc = cipher.encryptor()
    return enc.update(data) + enc.finalize()


def reference_embed_numpy(
    key: bytes,
    nonce: bytes,
    message_bytes: bytes,
    width: int = 512,
    height: int = 512,
    l: int = 1,
    u: np.ndarray | None = None,
    rng: np.random.RandomState | None = None,
) -> np.ndarray:
    """message -> (4, H/8, W/8) watermarked latent, scalar-loop style.

    Diffusion: tile message to capacity, zero-fill remainder (nodes.py:79-87).
    Encrypt with ChaCha20, expand to bits MSB-first (gs_insert.py:45-49), then
    per l-bit window y: z = norm.ppf((u + y)/2**l) filled C-order
    (gs_insert.py:58-66).
    """
    from scipy.stats import norm

    hb, wb = height // 8, width // 8
    elements = 4 * hb * wb
    capacity_bits = elements * l
    msg_bits = np.unpackbits(np.frombuffer(message_bytes, dtype=np.uint8))
    repeats = capacity_bits // msg_bits.size
    s_d_bits = np.zeros(capacity_bits, dtype=np.uint8)
    s_d_bits[: repeats * msg_bits.size] = np.tile(msg_bits, repeats)
    s_d = np.packbits(s_d_bits).tobytes()

    m = _chacha_encrypt(key, nonce, s_d)
    m_bits = "".join(format(byte, "08b") for byte in m)

    Z = np.zeros((4, hb, wb))
    index = 0
    for i in range(0, len(m_bits), l):
        window = m_bits[i : i + l]
        y = int(window, 2)
        if u is not None:
            uu = float(u.ravel()[index])
        elif rng is not None:
            uu = rng.uniform(0, 1)
        else:
            uu = np.random.uniform(0, 1)
        z = norm.ppf((uu + y) / 2**l)
        Z[index // (hb * wb), (index // wb) % hb, index % wb] = z
        index += 1
        if index >= elements:
            break
    return Z


def reference_decode_numpy(
    reversed_latents: np.ndarray,
    key: bytes,
    nonce: bytes,
    message_length: int,
    l: int = 1,
) -> str:
    """Latent -> binary message string, scalar-loop style (extract.py:72-101)."""
    from scipy.stats import norm

    bits = []
    for z in np.nditer(np.asarray(reversed_latents, dtype=np.float64)):
        y = int(norm.cdf(z) * 2**l)
        y = min(y, 2**l - 1)
        for j in range(l - 1, -1, -1):
            bits.append((y >> j) & 1)
    m_bytes = np.packbits(np.array(bits, dtype=np.uint8)).tobytes()
    s_d = _chacha_encrypt(key, nonce, m_bytes)  # XOR stream: encrypt == decrypt
    all_bits = "".join(format(byte, "08b") for byte in s_d)

    segments = [
        all_bits[i : i + message_length]
        for i in range(0, len(all_bits), message_length)
    ]
    segments = [s for s in segments if len(s) == message_length]
    out = ""
    for i in range(message_length):
        count_1 = sum(seg[i] == "1" for seg in segments)
        out += "1" if count_1 > len(segments) / 2 else "0"
    return out
