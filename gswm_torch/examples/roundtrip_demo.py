"""End-to-end Gaussian Shading roundtrip on the tiny preset (no weights
needed; swap the preset or pass ``model_dir`` for real use); the port of
``examples/roundtrip_demo.py``.

Demonstrates the full reference workflow (README.md:107-145 embed recipe +
extract.py:46-117 extraction) through gswm_torch's API:

  1. fit the tiny VAE so pixels round-trip (random weights otherwise),
  2. embed a message into watermarked initial noise Z_T,
  3. generate an image from it (the host-sampler role),
  4. attack the image (JPEG: the device DCT JPEG, which needs no PIL),
  5. invert the attacked image back to Z_T and decode the message,
  6. score bit accuracy + detection p-value.

Run:  python -m gswm_torch.examples.roundtrip_demo [--device cuda] [--seed 0]
(``--device cpu`` on the CPU: about a minute, most of it the VAE fit).
"""

from __future__ import annotations

import argparse

import torch

from gswm_torch.config import GSConfig
from gswm_torch.core import bits as bitops
from gswm_torch.core.decode import recover_message_bits
from gswm_torch.core.embed import embed_latents
from gswm_torch.distortions import device_attacks
from gswm_torch.eval.detection import bit_match_pvalue
from gswm_torch.pipelines import InversablePipeline
from gswm_torch.utils.fitting import fit_vae_roundtrip


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (cpu for the CPU)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the weights and draws")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--jpeg-quality", type=int, default=75)
    return ap


def main(argv=None) -> list[tuple[float, float]]:
    """Returns each image's (bit accuracy, p-value)."""
    args = build_parser().parse_args(argv)
    dev = torch.device(args.device)

    def generator(offset: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(args.seed + offset)

    # tiny preset: structurally a mini-SD; fit its VAE so pixels roundtrip
    pipe = InversablePipeline("tiny", device=dev, dtype=torch.float32, generator=generator(0))
    pipe.vae.load_state_dict(fit_vae_roundtrip(pipe, generator=generator(42)))
    pipe.weights_loaded_()

    cfg = GSConfig(
        key_hex="22" * 32,          # ChaCha20 key (os.urandom(32) in prod)
        nonce_hex="",               # empty -> derived key_hex[16:48]
        message="lthero",
        width=32, height=32, vae_scale=2, message_bits=32,
    )

    # embed: message -> encrypted, repeated, distribution-preserving Z_T
    zt, message_bytes = embed_latents(cfg, generator=generator(1), batch=4, device=dev)

    # generate (the role the reference hands to A1111/ComfyUI samplers)
    images = pipe.generate(zt, guidance_scale=1.0, num_steps=args.steps)

    # attack: JPEG on the device
    attacked = device_attacks.apply(images, "compression", args.jpeg_quality)

    # invert + decode (extract.py:46-101 equivalents)
    voted = recover_message_bits(pipe.invert(images=attacked, num_steps=args.steps), cfg)

    # score
    expected = torch.from_numpy(bitops.bytes_to_bits(message_bytes)).to(voted.device)
    scores = []
    for i, row in enumerate(voted):
        matching = int((row == expected).sum())
        acc, p = matching / expected.numel(), bit_match_pvalue(matching, expected.numel())
        print(f"image {i}: bit accuracy {acc:.3f}   p-value {p:.2e}")
        scores.append((acc, p))
    return scores


if __name__ == "__main__":
    main()
