"""Extraction CLI — flag-compatible with the reference's extract.py:179-211;
port of ``gswm.cli.gs_extract``, plus ``--device`` (default ``cuda``;
``--device cpu`` for the CPU).

The pipeline is built once and reused across every image and subdirectory,
and directory extraction batches images through the inversion (--batch).
A chunk that fails ends the run (the reference logs it and goes on): no
failure on the card is swallowed; the reports hold every chunk before it.
The host side (``load_images``: PIL, LANCZOS) and the device side
(``extract_arrays``: VAE encode, inversion, ``check_finite``, vote and
accuracy) are two functions, so a caller with images in memory, or with no
PIL, runs the device side alone.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from gswm_torch.config import GSConfig
from gswm_torch.core.bits import bits_to_bin_str
from gswm_torch.eval.metrics import calculate_bit_accuracy
from gswm_torch.eval.report import BatchReport, write_batch_info
from gswm_torch.utils.debug import check_finite


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Extract watermark from a image")
    p.add_argument("--model_id", default="stabilityai/stable-diffusion-2-1-base",
                   help="preset selector; offline, weights come from --model_dir")
    p.add_argument("--model_dir", default="",
                   help="local diffusers-layout checkpoint directory")
    p.add_argument("--images_directory_path", default="")
    p.add_argument("--single_image_path", default="")
    p.add_argument("--key_hex", required=True)
    p.add_argument("--nonce_hex", required=True,
                   help="empty -> middle 16 bytes of key_hex")
    p.add_argument("--original_message_hex", required=True)
    p.add_argument("--num_inference_steps", default=30, type=int)
    p.add_argument("--scheduler", default="DDIM", choices=["DDIM", "DPMs"])
    p.add_argument("--is_traverse_subdirectories", default=0, type=int)
    p.add_argument("--l", default=1, type=int)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--message_length", type=int, default=1024)
    # gswm extensions
    p.add_argument("--batch", type=int, default=8,
                   help="images per inversion batch (directory mode)")
    p.add_argument("--refine", type=int, default=0,
                   help="fixed-point refinement iterations per inversion step")
    p.add_argument("--resume", action="store_true",
                   help="skip images already present in results.jsonl")
    p.add_argument("--device", default="cuda",
                   help="torch device of the pipeline (cpu for the CPU)")
    return p


_MODEL_PRESETS = {
    "stabilityai/stable-diffusion-2-1-base": "sd-2-1-base",
    "stabilityai/stable-diffusion-2-1": "sd-2-1",
    "CompVis/stable-diffusion-v1-4": "sd-1-4",
}


def pipeline_dtype(device) -> torch.dtype:
    """bfloat16 on the card (what its kernels take), float32 elsewhere."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


def make_pipeline(args):
    from gswm_torch.pipelines import InversablePipeline

    preset = _MODEL_PRESETS.get(args.model_id, args.model_id)
    return InversablePipeline(preset, device=args.device,
                              dtype=pipeline_dtype(args.device),
                              model_dir=args.model_dir or None)


def make_config(args) -> GSConfig:
    return GSConfig(
        key_hex=args.key_hex,
        nonce_hex=args.nonce_hex or args.key_hex[16:48],
        message_bits=args.message_length,
        l=args.l,
        width=args.width,
        height=args.height,
    )


def load_images(paths, size) -> np.ndarray:
    """PIL load + LANCZOS resize, (B,3,H,W) in [0,1] (extract.py:31-37)."""
    from PIL import Image

    out = []
    for path in paths:
        im = Image.open(path).convert("RGB").resize(size, Image.LANCZOS)
        out.append(np.asarray(im, dtype=np.float32).transpose(2, 0, 1) / 255.0)
    return np.stack(out)


def extract_arrays(pipe, cfg, args, images, name: str = "images") -> list[tuple[str, float]]:
    """(B, 3, H, W) images in [0, 1] (numpy or a tensor on any device) ->
    [(extracted bits as a '0'/'1' string, bit accuracy against
    ``args.original_message_hex``)] per image: VAE encode, inversion and
    quantize / decrypt / vote on the pipeline's device (``extract_bits``),
    the recovered z_T checked for non-finite values."""
    voted, z = pipe.extract_bits(cfg, images=images, num_steps=args.num_inference_steps,
                                 scheduler=args.scheduler, refine=args.refine)
    check_finite(z, name=f"inverted latents ({name})")
    out = []
    for bits in voted.cpu().numpy():
        extracted = bits_to_bin_str(bits)
        _, acc = calculate_bit_accuracy(args.original_message_hex, extracted)
        out.append((extracted, acc))
    return out


def extract_batch(pipe, cfg, args, paths):
    """[(path, extracted bits, accuracy)] for the images at ``paths``."""
    imgs = load_images(paths, (args.width, args.height))
    results = extract_arrays(pipe, cfg, args, imgs, name=f"{paths[0]}...")
    return [(path, extracted, acc) for path, (extracted, acc) in zip(paths, results)]


def process_single_directory(pipe, cfg, args, dir_path):
    image_files = sorted(
        glob.glob(os.path.join(dir_path, "*.png"))
        + glob.glob(os.path.join(dir_path, "*.jpg"))
    )
    if not image_files:
        return
    report = BatchReport(dir_path, args)
    if args.resume:
        done = report.already_done()
        image_files = [p for p in image_files if os.path.basename(p) not in done]
    # A failing chunk ends the run, where the reference records the error and
    # goes on (extract.py:148-155): nothing in the port swallows a failure on
    # the card.  Every chunk before it is in the report; --resume skips them.
    try:
        for i in range(0, len(image_files), args.batch):
            chunk = image_files[i : i + args.batch]
            for path, extracted, acc in extract_batch(pipe, cfg, args, chunk):
                print(f"{os.path.basename(path)}  Bit Accuracy: {acc}")
                report.record(path, acc, extracted)
    finally:
        avg = report.close()
    if avg is not None:
        print(f"Average Bit Accuracy, {avg}")


def process_directory(pipe, cfg, args):
    root = args.images_directory_path
    if int(args.is_traverse_subdirectories) == 1:
        with open(os.path.join(root, "result.txt"), "a") as f:
            write_batch_info(f, args)
        for r, dirs, _files in os.walk(root):
            for d in dirs:
                process_single_directory(pipe, cfg, args, os.path.join(r, d))
        with open(os.path.join(root, "result.txt"), "a") as f:
            f.write("=" * 40 + "Batch End" + "=" * 40 + "\n\n")
    else:
        process_single_directory(pipe, cfg, args, root)


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = make_config(args)
    pipe = make_pipeline(args)
    if args.images_directory_path:
        process_directory(pipe, cfg, args)
    elif args.single_image_path:
        results = extract_batch(pipe, cfg, args, [args.single_image_path])
        path, extracted, acc = results[0]
        orig_bin, _ = calculate_bit_accuracy(args.original_message_hex, extracted)
        print(
            f"{os.path.basename(path)}\nOriginal Message: {orig_bin} \n"
            f"Extracted Message: {extracted}\nBit Accuracy: {acc}\n"
        )
    else:
        print("Please set the argument 'images_directory_path' or 'single_image_path'")


if __name__ == "__main__":
    main()
