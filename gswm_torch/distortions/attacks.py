"""Host-path attacks: PIL/numpy implementations of the 16 distortions.

Semantics match the reference's dispatch (`distortions`:86-237) — same
strength ranges, same per-image seed increment (`distortions`:71-79), same
compose-all chain (`distortions`:348-359) — implemented with PIL + numpy only
(the reference additionally leaned on torchvision; the geometric ops here are
re-derived, not translations).

The port's copy of ``gswm.distortions.attacks``: PIL is imported inside the
functions that need it, so the strength table and
``relative_strength_to_absolute`` import where there is no PIL, and the
'reversed' attack hands the pipeline a torch tensor.
"""

from __future__ import annotations

import io
import math
import random

import numpy as np

from gswm_torch.distortions.utils import set_random_seed, to_pil, to_tensor

# (identity_end, max_end) per attack (`distortions`:17-34)
DISTORTION_STRENGTH_PARAS = dict(
    rotation=(0, 360),
    scaling=(0, 1),
    resizedcrop=(1, 0.1),
    erasing=(0, 1),
    brightness=(1, 16),
    contrast=(1, 6),
    blurring=(0, 20),
    noise=(0, 0.5),
    compression=(100, 0),
    reversed=(0, 100),
    elastic=(0, 100),
    horizontal_flip=(0, 0),
    vertical_flip=(0, 0),
    togray=(0, 0),
    randomcrop=(1, 0),
    invert=(0, 0),
)


def relative_strength_to_absolute(strength: float, distortion_type: str) -> float:
    """relative in [0,1] -> absolute in the attack's range
    (`distortions`:37-49)."""
    lo, hi = DISTORTION_STRENGTH_PARAS[distortion_type]
    assert 0 <= strength <= 1
    s = strength * (hi - lo) + lo
    s = max(s, min(lo, hi))
    s = min(s, max(lo, hi))
    return s


def _center_square_params(size, scale, rng):
    """Area-scale square crop box at a random position — the semantics of
    torchvision RandomResizedCrop.get_params(scale=(s,s), ratio=(1,1))."""
    w, h = size
    area = h * w * scale
    side = int(round(math.sqrt(area)))
    side = min(side, h, w)
    i = rng.randint(0, h - side) if h > side else 0  # top
    j = rng.randint(0, w - side) if w > side else 0  # left
    return i, j, side, side


def apply_single_distortion(
    image,
    distortion_type: str,
    strength: float | None = None,
    distortion_seed: int = 0,
    pipe=None,
):
    """One attack on one PIL image.  ``pipe`` (InversablePipeline) powers the
    'reversed' regeneration attack (`distortions`:185-192)."""
    from PIL import Image, ImageEnhance, ImageFilter, ImageOps

    assert isinstance(image, Image.Image)
    set_random_seed(distortion_seed)
    rng = random.Random(distortion_seed)
    assert distortion_type in DISTORTION_STRENGTH_PARAS
    if strength is not None:
        lo, hi = DISTORTION_STRENGTH_PARAS[distortion_type]
        assert min(lo, hi) <= strength <= max(lo, hi)

    def pick(name):
        return (
            strength
            if strength is not None
            else rng.uniform(*DISTORTION_STRENGTH_PARAS[name])
        )

    if distortion_type == "rotation":
        # torchvision F.rotate and PIL Image.rotate are both counter-clockwise
        # for positive angles — no sign flip.
        return image.rotate(pick("rotation"), resample=Image.NEAREST)

    if distortion_type == "resizedcrop":
        scale = pick("resizedcrop")
        i, j, h, w = _center_square_params(image.size, scale, rng)
        crop = image.crop((j, i, j + w, i + h))
        return crop.resize(image.size, Image.BILINEAR)

    if distortion_type == "erasing":
        scale = pick("erasing")
        arr = np.array(image.convert("RGB"))
        i, j, h, w = _center_square_params(image.size, scale, rng)
        arr[i : i + h, j : j + w] = 0
        return Image.fromarray(arr)

    if distortion_type == "brightness":
        return ImageEnhance.Brightness(image).enhance(pick("brightness"))

    if distortion_type == "contrast":
        return ImageEnhance.Contrast(image).enhance(pick("contrast"))

    if distortion_type == "blurring":
        return image.filter(ImageFilter.GaussianBlur(int(pick("blurring"))))

    if distortion_type == "noise":
        std = pick("noise")
        x = np.asarray(image.convert("RGB"), dtype=np.float32) / 255.0
        noise = np.random.randn(*x.shape).astype(np.float32) * std
        x = np.clip(x + noise, 0, 1)
        return Image.fromarray((x * 255).round().astype(np.uint8))

    if distortion_type == "compression":
        quality = int(pick("compression"))
        buf = io.BytesIO()
        image.convert("RGB").save(buf, format="JPEG", quality=quality)
        return Image.open(buf)

    if distortion_type == "reversed":
        # regeneration attack: invert + re-generate through the pipeline
        # (`distortions`:302-322 does a full SD roundtrip)
        steps = int(pick("reversed")) or 50
        if pipe is None:
            raise ValueError("'reversed' needs pipe=InversablePipeline")
        import torch

        x = to_tensor([image], norm_type=None)
        z = pipe.invert(images=torch.from_numpy(x), num_steps=steps)
        img = pipe.generate(z, guidance_scale=1.0, num_steps=steps)
        return to_pil(img.cpu().numpy(), norm_type=None)[0]

    if distortion_type == "elastic":
        alpha = pick("elastic")
        return _elastic(image, alpha=alpha, sigma_rel=0.02, rng=rng)

    if distortion_type == "togray":
        return image.convert("L").convert("RGB")

    if distortion_type == "horizontal_flip":
        return ImageOps.mirror(image)

    if distortion_type == "vertical_flip":
        return ImageOps.flip(image)

    if distortion_type == "randomcrop":
        # crop then paste back on black at the same offset (`distortions`:207-222)
        scale = pick("randomcrop")
        i, j, h, w = _center_square_params(image.size, scale, rng)
        crop = image.crop((j, i, j + w, i + h))
        black = Image.new("RGB", image.size)
        black.paste(crop, (j, i))
        return black

    if distortion_type == "invert":
        return ImageOps.invert(image.convert("RGB"))

    if distortion_type == "scaling":
        scale = pick("scaling")
        new = (max(1, int(image.width * scale)), max(1, int(image.height * scale)))
        return image.resize(new, Image.LANCZOS)

    raise AssertionError(distortion_type)


def _elastic(image, alpha: float, sigma_rel: float, rng):
    """Elastic deformation: smooth random displacement field of magnitude
    ``alpha`` pixels (torchvision v2.ElasticTransform(alpha, sigma) semantics,
    `distortions`:193-200; sigma there is relative and tiny)."""
    from PIL import Image

    x = np.asarray(image.convert("RGB"), dtype=np.float32)
    h, w = x.shape[:2]
    sigma = max(sigma_rel * max(h, w), 1.0)
    rs = np.random.RandomState(rng.randint(0, 2**31 - 1))

    def field():
        f = rs.rand(h, w) * 2 - 1
        # separable gaussian smoothing
        k = int(3 * sigma) | 1
        ax = np.arange(k) - k // 2
        g = np.exp(-(ax**2) / (2 * sigma**2))
        g /= g.sum()
        f = np.apply_along_axis(lambda r: np.convolve(r, g, mode="same"), 1, f)
        f = np.apply_along_axis(lambda c: np.convolve(c, g, mode="same"), 0, f)
        return f * alpha

    dy, dx = field(), field()
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    sy = np.clip(yy + dy, 0, h - 1)
    sx = np.clip(xx + dx, 0, w - 1)
    y0 = np.floor(sy).astype(int)
    x0 = np.floor(sx).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (sy - y0)[..., None]
    wx = (sx - x0)[..., None]
    out = (
        x[y0, x0] * (1 - wy) * (1 - wx)
        + x[y1, x0] * wy * (1 - wx)
        + x[y0, x1] * (1 - wy) * wx
        + x[y1, x1] * wy * wx
    )
    return Image.fromarray(np.clip(out, 0, 255).astype(np.uint8))


def apply_distortion(
    images,
    distortion_type,
    strength=None,
    distortion_seed=0,
    same_operation=False,
    relative_strength=True,
    return_image=True,
    pipe=None,
):
    """Batch dispatch with per-image seed increment (`distortions`:52-83)."""
    from PIL import Image

    if not isinstance(images[0], Image.Image):
        images = to_pil(images)
    if relative_strength and strength is not None:
        strength = relative_strength_to_absolute(strength, distortion_type)
    out = []
    seed = distortion_seed
    for image in images:
        out.append(
            apply_single_distortion(image, distortion_type, strength, seed, pipe)
        )
        if not same_operation:
            seed += 1
    if not return_image:
        out = to_tensor(out)
    return out


def apply_multiple_distortions(image, distortion_params, distortion_seed=0, pipe=None):
    """Chain every enabled attack onto one image, seed+1 per attack
    (`distortions`:348-359)."""
    from PIL import Image

    assert isinstance(image, Image.Image)
    seed = distortion_seed
    applied = {}
    for dtype_, params in distortion_params.items():
        if params.get("enable"):
            s = relative_strength_to_absolute(params["relative_strength"], dtype_)
            image = apply_single_distortion(image, dtype_, s, seed, pipe)
            applied[dtype_] = s
            seed += 1
    return image, applied
