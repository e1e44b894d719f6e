"""optim_utils-parity helpers beyond the FFT core (SURVEY.md §2.3):
set_random_seed, transform_img, latents_to_imgs, image_distortion.

The port's copy of ``gswm.treering.compat``; PIL is imported inside the
functions (all three take or return PIL images)."""

from __future__ import annotations

import numpy as np

from gswm_torch.distortions.attacks import apply_single_distortion
from gswm_torch.distortions.utils import set_random_seed  # noqa: F401  (re-export)


def transform_img(image, target_size: int = 512) -> np.ndarray:
    """PIL -> (3, H, W) float in [-1, 1] (the torch transform chain the
    reference used: resize, center-crop, to-tensor, normalize)."""
    from PIL import Image

    w, h = image.size
    s = target_size / min(w, h)
    image = image.resize((round(w * s), round(h * s)), Image.BICUBIC)
    w, h = image.size
    left, top = (w - target_size) // 2, (h - target_size) // 2
    image = image.crop((left, top, left + target_size, top + target_size))
    arr = np.asarray(image.convert("RGB"), dtype=np.float32) / 255.0
    return arr.transpose(2, 0, 1) * 2.0 - 1.0


def latents_to_imgs(pipe, latents) -> list:
    """Decode latents through the pipeline VAE to PIL images."""
    from PIL import Image

    imgs = pipe.decode_image(latents).cpu().numpy()
    return [
        Image.fromarray((a.transpose(1, 2, 0) * 255).round().astype(np.uint8))
        for a in imgs
    ]


def image_distortion(img1, img2, args):
    """Apply the same parameterized distortion chain to a pair of images —
    optim_utils.image_distortion signature (r_degree, jpeg_ratio, crop_scale,
    gaussian_blur_r, gaussian_std, brightness_factor; None = skip)."""
    seed = getattr(args, "distortion_seed", 0)

    def chain(img):
        if getattr(args, "r_degree", None) is not None:
            img = apply_single_distortion(img, "rotation", args.r_degree, seed)
        if getattr(args, "jpeg_ratio", None) is not None:
            img = apply_single_distortion(img, "compression", args.jpeg_ratio,
                                          seed)
        if getattr(args, "crop_scale", None) is not None:
            img = apply_single_distortion(img, "randomcrop", args.crop_scale,
                                          seed)
        if getattr(args, "gaussian_blur_r", None) is not None:
            img = apply_single_distortion(img, "blurring",
                                          args.gaussian_blur_r, seed)
        if getattr(args, "gaussian_std", None) is not None:
            img = apply_single_distortion(img, "noise", args.gaussian_std, seed)
        if getattr(args, "brightness_factor", None) is not None:
            img = apply_single_distortion(img, "brightness",
                                          args.brightness_factor, seed)
        return img

    return chain(img1), chain(img2)
