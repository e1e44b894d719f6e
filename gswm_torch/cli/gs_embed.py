"""Embed CLI — watermark latent synthesis (and txt2img when weights or a
prompt are given); port of ``gswm.cli.gs_embed``, flag for flag, plus
``--device`` (default ``cuda``; ``--device cpu`` for the CPU).

``--message/--key_hex/--nonce_hex`` produce watermarked Z_T init noise,
saved as ``gs_latents.npy`` for any sampler, and which the port's own
pipeline renders with ``--model_dir`` or ``--prompt``.  Key material goes to
``info_data.txt`` exactly as the reference logs it (gs_insert.py:68-74) plus
a jsonl mirror (``eval.registry.KeyRegistry``).  A prompt is tokenized by
the port's own CLIP BPE (``models.tokenizer``) when ``--model_dir`` holds
its ``vocab.json`` and ``merges.txt``; without it generation is
unconditional, as in the reference.  PIL is imported only to write PNGs.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from gswm_torch.config import GSConfig, prepare_message_bytes
from gswm_torch.core.embed import embed_latents
from gswm_torch.eval.registry import KeyRegistry


def build_parser():
    p = argparse.ArgumentParser(description="Generate GS-watermarked init noise")
    p.add_argument("--message", default="")
    p.add_argument("--key_hex", default="")
    p.add_argument("--nonce_hex", default="")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--message_length", type=int, default=-1,
                   help="-1 = auto capacity table (nodes.py:26-49)")
    p.add_argument("--l", type=int, default=1)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--use_repeat", action="store_true",
                   help="A1111 semantics: quarter-size message tiled x4")
    p.add_argument("--n_samples", type=int, default=1)
    p.add_argument("--outdir", default="outputs")
    # generation (optional, needs local weights)
    p.add_argument("--model_dir", default="")
    p.add_argument("--preset", default="sd-2-1-base")
    p.add_argument("--prompt", default="")
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--scheduler", default="DDIM", choices=["DDIM", "DPMs"])
    p.add_argument("--device", default="cuda",
                   help="torch device of the embed and the pipeline (cpu for the CPU)")
    return p


def save_pngs(images, outdir: str) -> list[str]:
    """(B, 3, H, W) images in [0, 1] -> gs_00000.png, ... in ``outdir``."""
    from PIL import Image

    paths = []
    for i, im in enumerate(images):
        arr = (im.transpose(1, 2, 0) * 255).round().astype(np.uint8)
        path = os.path.join(outdir, f"gs_{i:05d}.png")
        Image.fromarray(arr).save(path)
        paths.append(path)
    return paths


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = GSConfig(
        key_hex=args.key_hex,
        nonce_hex=args.nonce_hex,
        message=args.message,
        message_bits=args.message_length,
        l=args.l,
        width=args.width,
        height=args.height,
        seed=args.seed,
        repeat4=args.use_repeat,
    ).resolved()

    os.makedirs(args.outdir, exist_ok=True)
    msg = prepare_message_bytes(cfg.message, cfg.message_bytes_len, cfg.repeat4)
    seed = cfg.seed if cfg.seed is not None else int.from_bytes(os.urandom(4), "little")
    generator = torch.Generator(device=args.device).manual_seed(seed)
    latents, msg = embed_latents(cfg, generator=generator, batch=args.n_samples,
                                 message_bytes=msg, device=args.device)

    key, nonce = cfg.resolve_key_nonce()
    registry = KeyRegistry(args.outdir)
    registry.record(key, nonce, msg, seed=cfg.seed, height=cfg.height,
                    width=cfg.width, message_length=cfg.resolved_message_bits)

    lat_path = os.path.join(args.outdir, "gs_latents.npy")
    np.save(lat_path, latents.cpu().numpy())
    print(f"latents: {tuple(latents.shape)} -> {lat_path}")
    print(f"key_hex: {cfg.key_hex}")
    print(f"nonce_hex: {cfg.nonce_hex}")
    print(f"message_hex: {msg.hex()}")

    if args.model_dir or args.prompt:
        from gswm_torch.cli.gs_extract import pipeline_dtype
        from gswm_torch.pipelines import InversablePipeline

        pipe = InversablePipeline(args.preset, device=args.device,
                                  dtype=pipeline_dtype(args.device),
                                  model_dir=args.model_dir or None)
        ids = None
        if args.prompt and args.model_dir:
            from gswm_torch.models.tokenizer import load_tokenizer

            ids = load_tokenizer(args.model_dir)([args.prompt] * args.n_samples)
        imgs = pipe.generate(latents, prompt_ids=ids,
                             guidance_scale=args.guidance_scale,
                             num_steps=args.num_inference_steps,
                             scheduler=args.scheduler)
        for path in save_pngs(imgs.cpu().numpy(), args.outdir):
            print(f"image -> {path}")


if __name__ == "__main__":
    main()
