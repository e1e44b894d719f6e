"""Batched attacks on the device of the images (NCHW float32 in [0, 1]).

Port of ``gswm.distortions.device``: the counterparts of the host/PIL attacks
so whole robustness sweeps run without leaving the card.  JPEG is a
DCT-quantization round trip (the standard differentiable approximation;
report-grade numbers use the exact host path).  Plain PyTorch throughout: the
reference computes these attacks in plain XLA.

Every function takes and returns (B, 3, H, W) float32 on the device of ``x``.
A randomized attack takes its draws as optional tensors (``draws``: the
normal field of ``noise``; the two uniforms ``(ui, uj)`` of ``resizedcrop``,
``erasing`` and ``randomcrop``; the two (H, W) uniform fields of ``elastic``)
and, when they are absent, draws them from ``generator`` (a
``torch.Generator`` on x's device; default: seed 0).  ``strength`` is
ABSOLUTE everywhere (``relative_strength_to_absolute`` converts).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _generator(x: torch.Tensor, generator) -> torch.Generator:
    if generator is not None:
        return generator
    return torch.Generator(device=x.device).manual_seed(0)


def _on(x: torch.Tensor, draw) -> torch.Tensor:
    return torch.as_tensor(draw, dtype=torch.float32).to(x.device)


def _two_uniforms(x, draws, generator):
    """The offsets' uniforms (ui, uj) as 0-d tensors on x's device."""
    if draws is None:
        u = torch.rand(2, generator=_generator(x, generator), device=x.device)
        return u[0], u[1]
    return _on(x, draws[0]), _on(x, draws[1])


def _grid(h: int, w: int, device):
    return torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device),
                          indexing="ij")


# -- elementwise ------------------------------------------------------------


def noise(x, std, draws=None, generator=None):
    if draws is None:
        draws = torch.randn(x.shape, generator=_generator(x, generator),
                            device=x.device)
    return torch.clamp(x + std * _on(x, draws), 0.0, 1.0)


def brightness(x, factor):
    """PIL ImageEnhance.Brightness: blend with black."""
    return torch.clamp(x * factor, 0.0, 1.0)


def _luma(x):
    return 0.299 * x[:, 0:1] + 0.587 * x[:, 1:2] + 0.114 * x[:, 2:3]


def contrast(x, factor):
    """PIL ImageEnhance.Contrast: blend with the mean luminance."""
    luma = _luma(x).mean(dim=(2, 3), keepdim=True)
    return torch.clamp(luma + factor * (x - luma), 0.0, 1.0)


def invert(x):
    return 1.0 - x


def togray(x):
    return _luma(x).expand_as(x).contiguous()


def horizontal_flip(x):
    return x.flip(-1)


def vertical_flip(x):
    return x.flip(-2)


# -- geometric ---------------------------------------------------------------


def _bilinear_gather(x, sy, sx):
    """Sample (B,C,H,W) at float coords sy/sx (H,W) with bilinear filtering."""
    h, w = x.shape[-2:]
    sy = torch.clamp(sy, 0.0, h - 1.0)
    sx = torch.clamp(sx, 0.0, w - 1.0)
    y0 = torch.floor(sy).long()
    x0 = torch.floor(sx).long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    wy = sy - y0
    wx = sx - x0
    return (
        x[..., y0, x0] * (1 - wy) * (1 - wx)
        + x[..., y1, x0] * wy * (1 - wx)
        + x[..., y0, x1] * (1 - wy) * wx
        + x[..., y1, x1] * wy * wx
    )


def rotation(x, angle_degrees):
    """Rotate about the center, zero-fill outside (F.rotate semantics)."""
    h, w = x.shape[-2:]
    theta = torch.deg2rad(torch.tensor(float(angle_degrees), dtype=torch.float32,
                                       device=x.device))
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = _grid(h, w, x.device)
    c, s = torch.cos(theta), torch.sin(theta)
    sy = cy + (yy - cy) * c - (xx - cx) * s
    sx = cx + (yy - cy) * s + (xx - cx) * c
    inside = (sy >= 0) & (sy <= h - 1) & (sx >= 0) & (sx <= w - 1)
    return _bilinear_gather(x, sy, sx) * inside.to(x.dtype)


def _keys_cubic(d):
    """Keys' cubic convolution kernel, a = -0.5, on d >= 0."""
    out = ((1.5 * d - 2.5) * d) * d + 1.0
    out = torch.where(d >= 1.0, ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0, out)
    return torch.where(d >= 2.0, torch.zeros_like(d), out)


def _cubic_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) resampling weights of one axis, built as
    ``jax.image.resize(..., "cubic")`` builds them: half-pixel centres, the
    kernel widened by 1/scale when shrinking (antialiasing), each output
    sample's weights normalised, and zeroed where the sample lies outside
    the input."""
    inv_scale = torch.tensor(1.0 / (n_out / n_in), dtype=torch.float32, device=device)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    # (i + 0.5) / scale - 0.5 rounded once: the reference's compiled graph
    # contracts it to a fused multiply-add (exact in float64, then rounded)
    sample = ((torch.arange(n_out, dtype=torch.float64, device=device) + 0.5)
              * inv_scale.double() - 0.5).float()
    d = (sample[None, :] - torch.arange(n_in, dtype=torch.float32,
                                        device=device)[:, None]).abs() / kernel_scale
    weights = _keys_cubic(d)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def resize_cubic(x, size):
    """(..., H, W) -> (..., size[0], size[1]) by Keys' cubic kernel (a = -0.5),
    antialiased when shrinking: the function of ``jax.image.resize(x, shape,
    "cubic")``, as one weight matrix an axis.  (torch's own bicubic
    interpolation uses a = -0.75 and is another function.)  An axis whose size does
    not change is left alone."""
    h, w = x.shape[-2:]
    nh, nw = size
    if nh != h:
        x = torch.einsum("...hw,hn->...nw", x, _cubic_weights(h, nh, x.device))
    if nw != w:
        x = torch.matmul(x, _cubic_weights(w, nw, x.device))
    return x


def scaling(x, scale: float):
    """LANCZOS-ish resize to scale (device path uses cubic)."""
    h, w = x.shape[-2:]
    return resize_cubic(x, (max(1, int(h * scale)), max(1, int(w * scale))))


def _square_side(scale, h: int, w: int) -> float:
    """Side of the square of area-fraction ``scale``, in float32 as the
    reference computes it, on the host."""
    side = np.floor(np.sqrt(np.float32(scale * h * w)))
    return float(min(side, np.float32(min(h, w))))


def resizedcrop(x, scale, draws=None, generator=None):
    """Random square area-crop then resize back (RandomResizedCrop
    scale=(s,s), ratio=(1,1))."""
    h, w = x.shape[-2:]
    side = _square_side(scale, h, w)
    ui, uj = _two_uniforms(x, draws, generator)

    def ramp(lo, n):
        # lo + k (side - 1) / (n - 1) with a true float32 division on every
        # device: by a Python number, CUDA multiplies by the reciprocal
        k = torch.arange(n, dtype=torch.float32, device=x.device)
        return lo + k * (side - 1) / torch.tensor(n - 1.0, device=x.device)

    sy, sx = torch.meshgrid(ramp(ui * (h - side), h), ramp(uj * (w - side), w),
                            indexing="ij")
    return _bilinear_gather(x, sy, sx)


def _rect_mask(shape_hw, i, j, hh, ww, device=None):
    h, w = shape_hw
    yy, xx = _grid(h, w, device)
    return (yy >= i) & (yy < i + hh) & (xx >= j) & (xx < j + ww)


def _random_square_mask(x, scale, draws, generator):
    h, w = x.shape[-2:]
    side = _square_side(scale, h, w)
    ui, uj = _two_uniforms(x, draws, generator)
    i = torch.floor(ui * (h - side))
    j = torch.floor(uj * (w - side))
    return _rect_mask((h, w), i, j, side, side, x.device).to(x.dtype)


def erasing(x, scale, draws=None, generator=None):
    """Zero a random square of area-fraction ``scale``."""
    return x * (1.0 - _random_square_mask(x, scale, draws, generator))


def randomcrop(x, scale, draws=None, generator=None):
    """Keep a random square of area-fraction ``scale``, zero the rest
    (crop + black repaste, `distortions`:207-222)."""
    return x * _random_square_mask(x, scale, draws, generator)


def _gaussian_taps(sigma: float, device):
    half = int(3 * sigma)
    ax = torch.arange(-half, half + 1, dtype=torch.float32, device=device)
    g = torch.exp(-(ax**2) / (2 * sigma**2))
    return g / g.sum(), half


def _separable_blur(x, g, half: int):
    """(N, 1, H, W): edge padding, then the taps down the rows and along the
    columns."""
    x = F.pad(x, (0, 0, half, half), mode="replicate")
    x = F.conv2d(x, g.reshape(1, 1, -1, 1))
    x = F.pad(x, (half, half, 0, 0), mode="replicate")
    return F.conv2d(x, g.reshape(1, 1, 1, -1))


def blurring(x, kernel_size):
    """Gaussian blur, PIL convention: radius = kernel_size, sigma ~ radius."""
    k = int(kernel_size)
    if k <= 0:
        return x
    g, half = _gaussian_taps(max(float(k), 1e-3), x.device)
    b, c, h, w = x.shape
    return _separable_blur(x.reshape(b * c, 1, h, w), g, half).reshape(b, c, h, w)


def elastic(x, alpha, draws=None, generator=None, sigma_rel=0.02):
    """Smooth random displacement field of magnitude alpha pixels."""
    h, w = x.shape[-2:]
    if draws is None:
        u = torch.rand((2, h, w), generator=_generator(x, generator), device=x.device)
    else:
        u = torch.stack([_on(x, draws[0]), _on(x, draws[1])])
    g, half = _gaussian_taps(max(sigma_rel * max(h, w), 1.0), x.device)
    d = _separable_blur((u * 2 - 1)[:, None], g, half)[:, 0] * alpha
    yy, xx = _grid(h, w, x.device)
    return _bilinear_gather(x, yy + d[0], xx + d[1])


# -- JPEG (DCT round trip) ---------------------------------------------------

_Q_LUMA = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    dtype=np.float32,
)
_Q_CHROMA = np.array(
    [
        [17, 18, 24, 47, 99, 99, 99, 99],
        [18, 21, 26, 66, 99, 99, 99, 99],
        [24, 26, 56, 99, 99, 99, 99, 99],
        [47, 66, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
    ],
    dtype=np.float32,
)


def _quality_scale(quality: int) -> float:
    q = min(max(int(quality), 1), 100)
    return 5000.0 / q if q < 50 else 200.0 - 2.0 * q


def _quant_tables(quality: int, device="cpu"):
    s = _quality_scale(quality)
    ql = np.clip(np.floor((_Q_LUMA * s + 50) / 100), 1, 255)
    qc = np.clip(np.floor((_Q_CHROMA * s + 50) / 100), 1, 255)
    return torch.from_numpy(ql).to(device), torch.from_numpy(qc).to(device)


@functools.lru_cache(maxsize=1)
def _dct_mat_host() -> np.ndarray:
    k = np.arange(8)
    n = np.arange(8)
    m = np.sqrt(2.0 / 8.0) * np.cos((2 * n[None, :] + 1) * k[:, None] * np.pi / 16)
    m[0] /= np.sqrt(2.0)
    return m.astype(np.float32)


def _dct_mat(device="cpu") -> torch.Tensor:
    return torch.from_numpy(_dct_mat_host()).to(device)


def _blockwise(x, fn):
    """x: (..., H, W) -> apply fn on 8x8 blocks."""
    h, w = x.shape[-2:]
    ph, pw = (-h) % 8, (-w) % 8
    lead = x.shape[:-2]
    x = F.pad(x.reshape((-1, 1, h, w)), (0, pw, 0, ph), mode="replicate")
    hh, ww = x.shape[-2], x.shape[-1]
    x = x.reshape(lead + (hh // 8, 8, ww // 8, 8)).transpose(-3, -2)  # (..., hb, wb, 8, 8)
    x = fn(x)
    x = x.transpose(-3, -2).reshape(lead + (hh, ww))
    return x[..., :h, :w]


def jpeg_compress(x, quality: int):
    """DCT-quantization JPEG round trip, 4:4:4, device-resident."""
    ql, qc = _quant_tables(quality, x.device)
    d = _dct_mat(x.device)

    r, g, b = x[:, 0], x[:, 1], x[:, 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 0.5
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 0.5

    def roundtrip(chan, q):
        def fn(blocks):
            c = (blocks - 0.5) * 255.0
            coef = torch.einsum("ij,...jk,lk->...il", d, c, d)
            coef = torch.round(coef / q) * q
            rec = torch.einsum("ji,...jk,kl->...il", d, coef, d)
            return rec / 255.0 + 0.5

        return _blockwise(chan, fn)

    y = roundtrip(y, ql)
    cb = roundtrip(cb, qc) - 0.5
    cr = roundtrip(cr, qc) - 0.5
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return torch.clamp(torch.stack([r, g, b], dim=1), 0.0, 1.0)


# -- dispatch ----------------------------------------------------------------

RANDOMIZED = ("noise", "resizedcrop", "erasing", "randomcrop", "elastic")


def apply(x, distortion_type: str, strength, generator=None, draws=None):
    """Batched device dispatch mirroring the host table.  ``strength`` is
    ABSOLUTE (callers convert with relative_strength_to_absolute)."""
    if distortion_type == "rotation":
        return rotation(x, strength)
    if distortion_type == "scaling":
        return scaling(x, float(strength))
    if distortion_type == "resizedcrop":
        return resizedcrop(x, strength, draws, generator)
    if distortion_type == "erasing":
        return erasing(x, strength, draws, generator)
    if distortion_type == "brightness":
        return brightness(x, strength)
    if distortion_type == "contrast":
        return contrast(x, strength)
    if distortion_type == "blurring":
        return blurring(x, strength)
    if distortion_type == "noise":
        return noise(x, strength, draws, generator)
    if distortion_type == "compression":
        return jpeg_compress(x, int(strength))
    if distortion_type == "elastic":
        return elastic(x, strength, draws, generator)
    if distortion_type == "togray":
        return togray(x)
    if distortion_type == "horizontal_flip":
        return horizontal_flip(x)
    if distortion_type == "vertical_flip":
        return vertical_flip(x)
    if distortion_type == "randomcrop":
        return randomcrop(x, strength, draws, generator)
    if distortion_type == "invert":
        return invert(x)
    raise ValueError(distortion_type)
