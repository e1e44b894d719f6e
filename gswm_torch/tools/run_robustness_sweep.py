"""Record the robustness-curve artifact with the PyTorch port.

Reproduces the reference's Results.png protocol (distortions:370-434 +
extract over the attacked outputs): 16 attacks x 5 strengths through
``gswm_torch.eval.sweep.run_sweep``, writes the rows as jsonl (the fields of
benchmarks/robustness_sweep_*_tpu.jsonl) and prints a markdown table.  The
port of tools/run_robustness_sweep.py, with ``--device`` in place of
``--platform``, the device JPEG as the default (the host JPEG needs PIL) and
its rows written, unless ``--out`` names a file, under the git-ignored
``build/`` as ``robustness_sweep_{preset}[_{res}]_torch.jsonl``.

CAVEAT (documented, deliberate): the weights are random, from a seed, and a
random-weight VAE is no autoencoder, so every row that goes through an image
sits near 0.5.  The run demonstrates the protocol and its plumbing and
measures its time; accuracies need a fitted or a real VAE, which the
repository does not hold (the reference's --fitted-vae file and its fit of
the tiny VAE are not ported).

Run on the card:

  python -m gswm_torch.tools.run_robustness_sweep --preset sd-2-1 --res 768 \
      --batch 2

On the CPU at CI scale:  ... --preset tiny --device cpu [--jpeg host]
"""

from __future__ import annotations

import argparse
import os

import torch

from gswm_torch.config import GSConfig
from gswm_torch.eval.sweep import DEFAULT_ATTACKS, run_sweep
from gswm_torch.pipelines import InversablePipeline

STRENGTHS = (0.1, 0.3, 0.5, 0.7, 0.9)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--jpeg", choices=("device", "host"), default="device")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--preset", default="tiny")
    # The reference's alternate extraction scheduler (extract.py:50-54,
    # --scheduler DPMs = 2nd-order DPM-Solver++ inversion); DDIM is its
    # default.
    ap.add_argument("--scheduler", choices=("DDIM", "DPMs"), default="DDIM")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="jsonl of the rows (default: build/robustness_sweep_"
                         "{preset}[_{res}]_torch.jsonl)")
    # BASELINE config 3's actual resolution is 768x768: --res 768 runs the
    # same protocol at 96x96 latents.
    ap.add_argument("--res", type=int, default=512,
                    help="image resolution for non-tiny presets (512|768)")
    # Input hardening: random-UNet outputs are low-texture, so value attacks
    # bite less than on real SD images.  --texture 0.15 blends a seeded
    # high-frequency field in before attacks.
    ap.add_argument("--texture", type=float, default=0.0)
    # The reference recommends 50-step extraction (README.md:265-266);
    # record that lossless row alongside the sweep's default step count.
    ap.add_argument("--fifty-step-row", action="store_true", default=True)
    ap.add_argument("--no-fifty-step-row", dest="fifty_step_row",
                    action="store_false")
    # Attack subset (comma-separated) — e.g. --attacks none,compression,noise
    ap.add_argument("--attacks", default=None)
    args = ap.parse_args(argv)

    tiny = args.preset == "tiny"
    if args.out is None:
        size = "" if tiny else f"_{args.res}"
        args.out = os.path.join("build", f"robustness_sweep_{args.preset}{size}_torch.jsonl")
    pipe = InversablePipeline(
        args.preset, device=args.device,
        dtype=torch.float32 if tiny else torch.bfloat16,
        generator=torch.Generator(device=args.device).manual_seed(0))
    print("WARNING: random VAE weights put every row at the ~0.5 floor (no "
          "fitted VAE is in the repository)", flush=True)
    if tiny:
        cfg = GSConfig(key_hex="22" * 32, nonce_hex="33" * 16,
                       message="lthero", width=32, height=32, vae_scale=2,
                       message_bits=32)
    else:
        cfg = GSConfig(key_hex="22" * 32, nonce_hex="33" * 16,
                       message="lthero", width=args.res, height=args.res,
                       message_bits=256)

    attacks = (tuple(args.attacks.split(",")) if args.attacks
               else DEFAULT_ATTACKS)
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    print(f"running {len(attacks)} attacks x {len(STRENGTHS)} strengths ...", flush=True)
    results = run_sweep(
        pipe, cfg, batch=args.batch, num_steps=args.steps,
        attacks=attacks, strengths=STRENGTHS, scheduler=args.scheduler,
        out_jsonl=args.out, jpeg=args.jpeg,
        texture_amp=args.texture,
        extract_steps_rows=(50,) if args.fifty_step_row else (),
    )

    print(f"\nwrote {args.out}\n")
    print("| attack | " + " | ".join(f"s={s:g}" for s in STRENGTHS) + " |")
    print("|---" * (len(STRENGTHS) + 1) + "|")
    by_attack: dict[str, list] = {}
    for r in results:
        by_attack.setdefault(r.attack, []).append(r)
    for attack, rows in by_attack.items():
        cells = " | ".join(f"{r.bit_accuracy_mean:.3f}" for r in rows)
        print(f"| {attack} | {cells} |")
    return results


if __name__ == "__main__":
    main()
