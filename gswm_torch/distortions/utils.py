"""The port's copy of ``gswm.distortions.utils`` (PIL imported inside the
functions that need it: the package imports where there is no PIL).

The `utils` module the reference's distortion bench imports but does not
ship (`distortions`:11).  API recovered from call sites: set_random_seed
(`distortions`:91), to_tensor(images, norm_type=None) (`distortions`:132,171),
to_pil(tensor, norm_type=None) (`distortions`:137,173)."""

from __future__ import annotations

import random

import numpy as np


def set_random_seed(seed: int = 0):
    random.seed(seed)
    np.random.seed(seed % (2**32))


def to_tensor(images, norm_type: str | None = "naive") -> np.ndarray:
    """List of PIL images -> (B, C, H, W) float array in [0,1]
    ("naive" norm maps to [-1,1] like WAVES; None keeps [0,1])."""
    arrs = []
    for im in images:
        a = np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0
        arrs.append(a.transpose(2, 0, 1))
    x = np.stack(arrs)
    if norm_type == "naive":
        x = x * 2.0 - 1.0
    return x


def to_pil(tensor, norm_type: str | None = "naive") -> list:
    """(B, C, H, W) array -> list of PIL images."""
    from PIL import Image

    x = np.asarray(tensor, dtype=np.float32)
    if x.ndim == 3:
        x = x[None]
    if norm_type == "naive":
        x = (x + 1.0) / 2.0
    x = np.clip(x, 0.0, 1.0)
    out = []
    for a in x:
        out.append(Image.fromarray((a.transpose(1, 2, 0) * 255).round().astype(np.uint8)))
    return out
