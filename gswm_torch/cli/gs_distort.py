"""Distortion CLI — flag-compatible with the reference's `distortions`
sweep script (distortions:370-434): fixed type+strength, strength sweeps,
all-enabled-types sweeps, and --add2one compose-all mode.

The port of ``gswm.cli.gs_distort`` (console entry ``gs-distort-torch``).
Where the reference runs image by image on the host unless ``--device`` is
given, the port runs the 15 batched attacks on the card, a whole directory
as one batch, and raises where there is no card: ``--device cpu`` runs the
same batched functions on the CPU, ``--host`` the reference's PIL attacks
image by image (byte for byte the reference's files).  ``--add2one``
composes on the host in either case: it has no batched counterpart.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from gswm_torch.distortions import (
    DISTORTION_STRENGTH_PARAS,
    apply_distortion,
    apply_multiple_distortions,
    relative_strength_to_absolute,
)

# compose-all defaults (`distortions`:330-346)
DISTORTION_TYPES_NEED2DEAL = {
    "rotation": {"relative_strength": 0.5, "enable": 1},
    "scaling": {"relative_strength": 0.3, "enable": 0},
    "resizedcrop": {"relative_strength": 0.5, "enable": 0},
    "erasing": {"relative_strength": 0.5, "enable": 0},
    "brightness": {"relative_strength": 0.5, "enable": 0},
    "contrast": {"relative_strength": 0.5, "enable": 0},
    "blurring": {"relative_strength": 0.5, "enable": 0},
    "noise": {"relative_strength": 0.5, "enable": 0},
    "compression": {"relative_strength": 0.3, "enable": 0},
    "elastic": {"relative_strength": 0.5, "enable": 0},
    "horizontal_flip": {"relative_strength": 0.5, "enable": 0},
    "vertical_flip": {"relative_strength": 0.5, "enable": 0},
    "togray": {"relative_strength": 0.5, "enable": 0},
    "randomcrop": {"relative_strength": 0.3, "enable": 0},
    "invert": {"relative_strength": 0.5, "enable": 0},
}


def _list_images(d):
    return sorted(
        f for f in os.listdir(d)
        if f.lower().endswith((".png", ".jpg", ".jpeg"))
    )


def process_images_in_directory(
    input_dir, output_dir_base, distortion_type, strength=None,
    distortion_seed=0, same_operation=False, relative_strength=True,
    use_device=True, device="cuda",
):
    """One attack at one strength over a directory, into
    ``{output_dir_base}/{type}_{absolute strength}``.  The whole directory
    runs as one batch on ``device`` (the card unless another is named) with
    draws from ``distortion_seed``; ``use_device=False`` runs the PIL attacks
    image by image on the host instead."""
    from PIL import Image

    abs_strength = (
        relative_strength_to_absolute(strength, distortion_type)
        if relative_strength else strength
    )
    output_dir = os.path.join(
        output_dir_base, f"{distortion_type}_{round(abs_strength, 2)}"
    )
    os.makedirs(output_dir, exist_ok=True)

    names = _list_images(input_dir)
    if use_device:
        import torch

        from gswm_torch.distortions import device as dev
        from gswm_torch.distortions.utils import to_pil, to_tensor

        imgs = [Image.open(os.path.join(input_dir, n)) for n in names]
        x = torch.from_numpy(to_tensor(imgs, norm_type=None)).to(device)
        out = dev.apply(x, distortion_type, abs_strength,
                        generator=torch.Generator(device=device).manual_seed(
                            distortion_seed))
        for n, im in zip(names, to_pil(out.cpu().numpy(), norm_type=None)):
            im.save(os.path.join(output_dir, n))
        return output_dir

    for n in names:
        image = Image.open(os.path.join(input_dir, n))
        out = apply_distortion(
            [image], distortion_type, strength=strength,
            distortion_seed=distortion_seed, same_operation=same_operation,
            relative_strength=relative_strength,
        )[0]
        out.convert("RGB").save(os.path.join(output_dir, n))
    return output_dir


def main(argv=None):
    p = argparse.ArgumentParser(description="Apply distortions to images in a directory.")
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir_base", required=True)
    p.add_argument("--distortion_type", choices=list(DISTORTION_STRENGTH_PARAS))
    p.add_argument("--strength", type=float, default=None)
    p.add_argument("--sgstart", type=float, default=0.1)
    p.add_argument("--sgend", type=float, default=1.0)
    p.add_argument("--distortion_seed", type=int, default=0)
    p.add_argument("--same_operation", action="store_true")
    p.add_argument("--relative_strength", action="store_true")
    p.add_argument("--add2one", action="store_true")
    p.add_argument("--device", nargs="?", const="cuda", default="cuda",
                   help="device of the batched attacks (default: the card; "
                        "the reference's bare --device means the same)")
    p.add_argument("--host", action="store_true",
                   help="run the PIL attacks image by image on the host")
    args = p.parse_args(argv)
    where = dict(use_device=not args.host, device=args.device)

    if args.add2one:
        from PIL import Image

        for n in _list_images(args.input_dir):
            image = Image.open(os.path.join(args.input_dir, n))
            out, applied = apply_multiple_distortions(
                image, DISTORTION_TYPES_NEED2DEAL, args.distortion_seed
            )
            sdir = "_".join(f"{k}_{round(v, 2)}" for k, v in applied.items())
            outdir = os.path.join(args.output_dir_base, sdir)
            os.makedirs(outdir, exist_ok=True)
            out.convert("RGB").save(os.path.join(outdir, n))
    elif args.distortion_type and args.strength is not None:
        process_images_in_directory(
            args.input_dir, args.output_dir_base, args.distortion_type,
            strength=args.strength, distortion_seed=args.distortion_seed,
            same_operation=args.same_operation,
            relative_strength=args.relative_strength, **where,
        )
    elif args.distortion_type:
        for s in np.arange(args.sgstart, args.sgend, 0.1):
            process_images_in_directory(
                args.input_dir, args.output_dir_base, args.distortion_type,
                strength=float(s), distortion_seed=args.distortion_seed,
                same_operation=args.same_operation,
                relative_strength=True, **where,
            )
    else:
        for dtype_, params in DISTORTION_TYPES_NEED2DEAL.items():
            if params["enable"]:
                for s in np.arange(args.sgstart, args.sgend, 0.1):
                    process_images_in_directory(
                        args.input_dir, args.output_dir_base, dtype_,
                        strength=float(s),
                        distortion_seed=args.distortion_seed,
                        same_operation=args.same_operation,
                        relative_strength=True, **where,
                    )


if __name__ == "__main__":
    main()
