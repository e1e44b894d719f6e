"""Tree-Ring watermarking core (FFT-domain injection + detection).

Port of ``gswm.treering.core``.  API parity with the recovered optim_utils
surface (SURVEY.md §2.3):
get_watermarking_mask (circle/square masks, w_radius/w_channel),
get_watermarking_pattern (seed_ring/zeros/rand/const/ring via
fftshift(fft2)), inject_watermark (ifft2(ifftshift)), eval_watermark (L1 in
FFT domain over the mask), get_p_value (noncentral chi-square tail).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _circle_mask(size: int, r: int) -> np.ndarray:
    y, x = np.ogrid[:size, :size]
    cy = cx = size // 2
    return ((x - cx) ** 2 + (y - cy) ** 2) <= r**2


def _shifted_fft(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.fftshift(torch.fft.fft2(x.to(torch.complex64)), dim=(-1, -2))


def get_watermarking_mask(
    latents_shape: tuple, w_channel: int = 0, w_radius: int = 10,
    mask_shape: str = "circle", device="cuda",
) -> torch.Tensor:
    """Boolean mask over (B, C, H, W) selecting the watermarked FFT region.

    w_channel = -1 watermarks every channel.
    """
    b, c, h, w = latents_shape
    mask = np.zeros(latents_shape, dtype=bool)
    if mask_shape == "circle":
        m = _circle_mask(h, w_radius)
    elif mask_shape == "square":
        m = np.zeros((h, w), dtype=bool)
        cy, cx = h // 2, w // 2
        m[cy - w_radius : cy + w_radius, cx - w_radius : cx + w_radius] = True
    elif mask_shape == "no":
        return torch.from_numpy(mask).to(device)
    else:
        raise ValueError(mask_shape)
    if w_channel == -1:
        mask[:, :] = m
    else:
        mask[:, w_channel] = m
    return torch.from_numpy(mask).to(device)


def get_watermarking_pattern(
    latents_shape: tuple, w_pattern: str = "ring", w_radius: int = 10,
    base=None, generator: Optional[torch.Generator] = None, device="cuda",
) -> torch.Tensor:
    """Complex FFT-domain pattern (B, C, H, W) on ``device``.  ``base``: the
    normal field the pattern is the spectrum of, else drawn from
    ``generator`` (on ``device``; default: seed 0)."""
    b, c, h, w = latents_shape
    if w_pattern == "zeros":
        return torch.zeros(latents_shape, dtype=torch.complex64, device=device)
    if w_pattern == "const":
        return torch.zeros(latents_shape, dtype=torch.complex64, device=device) + 1.0
    if base is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        base = torch.randn(latents_shape, generator=generator, device=device)
    fft = _shifted_fft(torch.as_tensor(base, dtype=torch.float32).to(device))

    if w_pattern == "rand":
        return fft
    if w_pattern in ("ring", "seed_ring"):
        # concentric rings: every FFT coefficient inside radius r takes the
        # constant drawn at that ring's edge, innermost ring last
        pattern = fft
        for r in range(w_radius, 0, -1):
            ring = torch.from_numpy(_circle_mask(h, r)).to(device)[None, None]
            val = fft[..., h // 2, h // 2 - r]  # (B, C)
            pattern = torch.where(ring, val[..., None, None], pattern)
        return pattern
    raise ValueError(w_pattern)


def inject_watermark(latents: torch.Tensor, mask: torch.Tensor,
                     pattern: torch.Tensor) -> torch.Tensor:
    """Replace masked FFT coefficients with the pattern; return real latents
    (fft2 -> patch -> ifft2, optim_utils.inject_watermark semantics)."""
    fft = torch.where(mask, pattern, _shifted_fft(latents))
    out = torch.fft.ifft2(torch.fft.ifftshift(fft, dim=(-1, -2)))
    return out.real.to(torch.float32)


def eval_watermark(reversed_latents: torch.Tensor, pattern: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Per-image L1 distance between recovered FFT and the pattern, over the
    mask (lower = watermarked)."""
    diff = (_shifted_fft(reversed_latents) - pattern).abs() * mask
    denom = torch.clamp(mask.sum(dim=(1, 2, 3)), min=1)
    return diff.sum(dim=(1, 2, 3)) / denom


def get_p_value(reversed_latents, pattern, mask) -> list[float]:
    """Detection p-value via the noncentral chi-square tail
    (optim_utils.get_p_value construction)."""
    from scipy.stats import ncx2

    ps = []
    m = torch.as_tensor(mask).cpu().numpy()
    target = torch.as_tensor(pattern).cpu().numpy()
    arr = _shifted_fft(torch.as_tensor(reversed_latents)).cpu().numpy()
    for i in range(arr.shape[0]):
        sel = m[i] if m.ndim == 4 else m
        obs = np.concatenate([arr[i].real[sel], arr[i].imag[sel]])
        tgt = np.concatenate([target[i].real[sel], target[i].imag[sel]])
        sigma = obs.std() + 1e-9
        lam = (tgt**2).sum() / sigma**2
        x = ((obs - tgt) ** 2).sum() / sigma**2
        ps.append(float(ncx2.cdf(x, df=obs.size, nc=lam)))
    return ps
