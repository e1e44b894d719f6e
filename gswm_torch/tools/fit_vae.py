"""Fit sd-2-1-base's VAE architecture (83.7M parameters, random init from a
seed) for encode-decode identity, so that the robustness bench at 512x512
and 768x768 certifies signal, not plumbing; port of tools/fit_sd21_vae.py.

No SD checkpoint is in the repository, and with random VAE weights the pixel
round trip destroys the watermark (every attacked row near 0.5).  Adam on
``encode(clip(decode(z))) ~= z`` over the latent scales a random UNet's DDIM
trajectory produces (8-18x unit scale) puts the full-size architecture in a
real VAE's regime (``gswm_torch.utils.fitting``).  Progressive resolution:
the VAE is fully convolutional, so most fitting happens at cheap 16x16
latents (128x128 images), then short refinements at 32x32 and the target
64x64 (512x512) adapt the mid-block attention to its real token count.

The VAE alone is built (no pipeline: the UNet would sit next to Adam's state
for nothing), in float32 master parameters; on the card the fit computes in
bfloat16 under autocast.  After each stage the float32 state dict is written
with ``torch.save`` to ``--out`` (default ``build/fitted_vae_sd21arch.pt``,
git-ignored), so a later stage that fails loses nothing before it: resume
with ``--init``.  ``tools/run_robustness_sweep.py --fitted-vae`` loads it.
Sign fidelity is read on a bfloat16 copy, the weights a pipeline runs.

Run on the card (about 10 minutes for the default stages):

  python -m gswm_torch.tools.fit_vae
  python -m gswm_torch.tools.fit_vae --init build/fitted_vae_sd21arch.pt \\
      --check 64,96,128
"""

from __future__ import annotations

import argparse
import copy
import os
import time

import torch

from gswm_torch.models.configs import PRESETS
from gswm_torch.models.layers import init_random_, to_compute_dtype_
from gswm_torch.models.vae import AutoencoderKL
from gswm_torch.utils.fitting import fit_vae_roundtrip

OUT = os.path.join("build", "fitted_vae_sd21arch.pt")
# (latent side, steps, batch, lr) per stage: most of the optimisation at the
# cheap resolution, short adaptation at the real one
STAGES = "16:1500:32:1e-3,32:500:16:3e-4,64:250:8:1e-4"


def parse_stages(text: str) -> list[tuple[int, int, int, float]]:
    """``"hw:steps:batch:lr,..."`` -> [(hw, steps, batch, lr), ...]."""
    out = []
    for stage in text.split(","):
        hw, steps, batch, lr = stage.split(":")
        out.append((int(hw), int(steps), int(batch), float(lr)))
    return out


def fid_batch(hw: int) -> int:
    """The fidelity batch at ``hw`` x ``hw`` latents: batch * hw^2 held at
    the 8 x (64 x 64) of the reference's operating point."""
    return max(1, 64 * 64 * 8 // (hw * hw))


def build_vae(preset: str = "sd-2-1-base", device="cuda", seed: int = 0) -> AutoencoderKL:
    """``preset``'s VAE in float32, parameters from a generator seeded
    ``seed`` on ``device`` (the pipeline's init rule, ``init_random_``)."""
    with torch.device("meta"):
        vae = AutoencoderKL(PRESETS[preset].vae)
    vae.to_empty(device=device)
    init_random_(vae, torch.Generator(device=device).manual_seed(seed))
    return vae.eval().requires_grad_(False)


def compute_copy(vae: AutoencoderKL, dtype: torch.dtype = torch.bfloat16) -> AutoencoderKL:
    """A copy of ``vae`` in the compute dtype a pipeline runs it in on the
    card (``to_compute_dtype_``: norms float32).  On the CPU, float32."""
    dev = next(vae.parameters()).device
    if dev.type != "cuda":
        dtype = torch.float32
    return to_compute_dtype_(copy.deepcopy(vae), dev, dtype)


@torch.inference_mode()
def sign_agreement(vae, z: torch.Tensor) -> float:
    """Fraction of latent elements whose sign survives decode -> clip ->
    encode: the element-level quantity the majority vote consumes."""
    img = torch.clamp(vae.decode(z), -1.0, 1.0)
    z_back = vae.encode(img)
    return float((torch.sign(z_back) == torch.sign(z)).float().mean())


def sign_fidelity(vae, latent_hw, batch: int = 8, scale: float = 14.0,
                  generator=None) -> float:
    """``sign_agreement`` on ``scale * N(0, 1)`` latents of shape (batch,
    latent_channels, *latent_hw) from ``generator`` (default: seed 123 on
    the VAE's device); tools/fit_sd21_vae.py:37-57."""
    dev = next(vae.parameters()).device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(123)
    h, w = latent_hw
    z = scale * torch.randn((batch, vae.config.latent_channels, h, w), device=dev,
                            generator=generator)
    return sign_agreement(vae, z)


def run_stage(vae, hw: int, steps: int, batch: int, lr: float,
              spectral: float = 0.0) -> dict:
    """One fit stage on ``vae`` (in place), then its sign fidelity at the
    stage's side on a compute copy.  Returns what the tool prints."""
    dev = next(vae.parameters()).device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    fit_vae_roundtrip(vae, steps=steps, batch=batch, lr=lr, latent_hw=(hw, hw),
                      spectral=spectral)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0
    fid = sign_fidelity(compute_copy(vae), (hw, hw), batch=fid_batch(hw))
    return dict(hw=hw, steps=steps, batch=batch, lr=lr, wall_s=wall,
                steps_per_s=steps / wall, fidelity=fid, peak_gib=peak)


def format_stage(r: dict) -> str:
    return (f"stage {r['hw']}x{r['hw']}: {r['steps']} steps, batch {r['batch']}, lr "
            f"{r['lr']:g}, {r['wall_s']:.2f} s = {r['steps_per_s']:.4f} steps/s, sign "
            f"fidelity {r['fidelity']:.4f}, peak device memory {r['peak_gib']:.2f} GiB")


def card_line(dev) -> str:
    """The card's name and power limit (nvidia-smi), or the CPU's word."""
    if dev.type != "cuda":
        return "cpu"
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--preset", default="sd-2-1-base")
    ap.add_argument("--stages", default=STAGES,
                    help="hw:steps:batch:lr per stage, comma-separated")
    # resume or extend: a new resolution costs a short refinement, not a refit
    ap.add_argument("--init", default=None, help="a fitted state (.pt) to start from")
    # measurement only: sign fidelity at the given latent sides, no fit
    ap.add_argument("--check", default=None, help="e.g. --check 64,96,128 (with --init)")
    # weight of the natural-spectrum (1/f^2) term on decoded images
    ap.add_argument("--spectral", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    vae = build_vae(args.preset, dev)
    if args.init:
        vae.load_state_dict(torch.load(args.init, map_location=dev, weights_only=True))
        print(f"initialized from {args.init}", flush=True)
    print(f"on {card_line(dev)}", flush=True)

    if args.check:
        bf = compute_copy(vae)
        for hw in (int(x) for x in args.check.split(",")):
            b = fid_batch(hw)
            print(f"sign fidelity @{hw}x{hw} ({hw * 8}px, batch {b}): "
                  f"{sign_fidelity(bf, (hw, hw), batch=b):.4f}", flush=True)
        return None

    print(f"preset {args.preset}; initial sign fidelity @16x16: "
          f"{sign_fidelity(compute_copy(vae), (16, 16)):.4f}", flush=True)
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    results = []
    for hw, steps, batch, lr in parse_stages(args.stages):
        r = run_stage(vae, hw, steps, batch, lr, args.spectral)
        results.append(r)
        print(format_stage(r), flush=True)
        torch.save(vae.state_dict(), args.out)
    fid64 = sign_fidelity(compute_copy(vae), (64, 64))
    print(f"final sign fidelity @64x64 (512px): {fid64:.4f}", flush=True)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB)", flush=True)
    return results


if __name__ == "__main__":
    main()
