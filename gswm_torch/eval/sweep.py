"""Robustness sweep — reproduces the reference's Results.png protocol
(BASELINE config 3): generate watermarked images, attack at increasing
strengths, extract, and report bit accuracy per (attack, strength).

Port of ``gswm.eval.sweep``.  Attacks run batched on the pipeline's device
(gswm_torch.distortions.device); images and latents stay there for the whole
sweep, and one transfer a row brings the voted bits to the host.  Results
land in jsonl.

Randomness: one ``torch.Generator`` on the pipeline's device seeds the embed
and the texture; each randomized attack draws from a generator of its own,
seeded by ``attack_seed`` from the sweep's seed and the attack's name, the
same at every strength.  (The reference folds ``hash(attack)`` into its key,
which changes from process to process; ``zlib.crc32`` does not.)  ``draws``
feeds explicit draws instead, for parity tests.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from gswm_torch.config import GSConfig
from gswm_torch.core import bits as bitops
from gswm_torch.core.decode import recover_message_bits
from gswm_torch.core.embed import embed_latents
from gswm_torch.distortions import device as dev
from gswm_torch.distortions.attacks import relative_strength_to_absolute
from gswm_torch.eval.detection import tpr_at_fpr
from gswm_torch.utils.io import write_jsonlines

# "none" is the lossless control (BASELINE.md row 1: 100% bit accuracy with
# no distortion) — it pins the sweep's ceiling so attack rows read relative
# to what the model/VAE pair can recover at all.
DEFAULT_ATTACKS = (
    "none",
    "compression", "blurring", "noise", "brightness", "contrast", "elastic",
    "erasing", "resizedcrop", "scaling", "randomcrop", "rotation",
    "horizontal_flip", "vertical_flip", "togray", "invert", "reversed",
)


@dataclasses.dataclass
class SweepResult:
    attack: str
    relative_strength: float
    absolute_strength: float
    bit_accuracy_mean: float
    bit_accuracies: list[float]
    tpr_at_1e6: float
    # extraction scheduler (extract.py:50-54's --scheduler: DDIM | DPMs);
    # default matches every pre-round-5 artifact, which was DDIM-only
    scheduler: str = "DDIM"


def attack_seed(seed: int, attack: str) -> int:
    """The seed of one attack's draws: the sweep's seed and the CRC-32 of the
    attack's name, the same in every process."""
    return (seed + zlib.crc32(attack.encode())) % 2**63


def _add_texture(images, amp: float, generator=None, draws=None):
    """Blend a seeded high-frequency texture field into images in [0,1].

    The field is pixel-level uniform noise minus its own 3x3 box blur —
    zero-mean, concentrated above the blur's cutoff, i.e. exactly the band
    JPEG quantization and blurring attacks remove first.  ``draws``: the
    uniform field in [0, 1), else drawn from ``generator``; the 'none'
    control and every attack row see the same inputs.
    """
    if draws is None:
        draws = torch.rand(images.shape, generator=generator, device=images.device)
    u = torch.as_tensor(draws, dtype=torch.float32).to(images.device) - 0.5
    k = torch.full((1, 1, 3, 3), 1.0 / 9.0, device=images.device)
    blur = F.conv2d(u.reshape((-1, 1) + images.shape[-2:]), k,
                    padding=1).reshape(images.shape)
    return torch.clamp(images + amp * (u - blur), 0.0, 1.0)


def _host_jpeg(images, quality: int) -> np.ndarray:
    """Exact libjpeg round-trip via PIL (`distortions`:175-184 semantics) —
    the report-grade compression path; the on-device DCT JPEG is the fast
    approximation (SURVEY.md §7.3: "ship both, report with the exact one").
    Needs PIL: raises ImportError where there is none."""
    from PIL import Image

    from gswm_torch.distortions.attacks import apply_single_distortion

    arr = torch.as_tensor(images).cpu().numpy()  # (B, 3, H, W) in [0, 1]
    out = []
    for x in arr:
        im = Image.fromarray(
            (np.transpose(x, (1, 2, 0)) * 255).round().astype(np.uint8)
        )
        im = apply_single_distortion(im, "compression", float(quality))
        out.append(
            np.transpose(np.asarray(im, np.float32) / 255.0, (2, 0, 1))
        )
    return np.stack(out)


def run_sweep(
    pipe,
    cfg: GSConfig,
    batch: int = 8,
    num_steps: int = 30,
    attacks: Iterable[str] = DEFAULT_ATTACKS,
    strengths: Iterable[float] = (0.1, 0.3, 0.5, 0.7, 0.9),
    generator: Optional[torch.Generator] = None,
    scheduler: str = "DDIM",
    out_jsonl: Optional[str] = None,
    guidance_scale: float = 1.0,
    jpeg: str = "device",
    texture_amp: float = 0.0,
    extract_steps_rows: Iterable[int] = (),
    draws: Optional[dict] = None,
) -> list[SweepResult]:
    """``jpeg`` selects the compression implementation: 'device' = batched
    DCT round-trip on the card (fast, approximate), 'host' = exact libjpeg via
    PIL (what the reference's bench uses).

    ``texture_amp`` > 0 blends a seeded high-frequency texture field into
    the generated images before any attack (input hardening: random-UNet
    outputs are low-texture, so value attacks like JPEG bite less than on
    real SD images).  The 'none' control then shows whether the texture alone
    costs accuracy, and attack rows degrade the way textured real images
    would.

    ``extract_steps_rows`` adds extra lossless control rows extracted at
    other step counts — e.g. (50,) records the reference's recommended
    50-step extraction setting (README.md:265-266) alongside the sweep's
    default.  Reported as attack='none@{n}step'.

    ``generator``: on ``pipe.device``; default seed 0.  ``draws``: explicit
    draws by name, each in place of the generator's: ``"u"`` the embed's
    uniforms (batch, elements), ``"texture"`` the texture's uniform field,
    and an attack's name the draws of ``distortions.device.apply``.
    """
    if jpeg not in ("device", "host"):
        raise ValueError(f"jpeg must be 'device' or 'host', got {jpeg!r}")
    device = pipe.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    draws = draws or {}
    strengths = tuple(strengths)

    zT, msg = embed_latents(cfg, generator=generator, batch=batch,
                            u=draws.get("u"), device=device)
    expected = bitops.bytes_to_bits(msg)
    images = pipe.generate(zT, guidance_scale=guidance_scale,
                           num_steps=num_steps, scheduler=scheduler)
    if texture_amp > 0.0:
        images = _add_texture(images, texture_amp, generator, draws.get("texture"))

    def row(attack, rel, absolute, attacked, steps):
        z_back = pipe.invert(images=attacked, num_steps=steps, scheduler=scheduler)
        voted = recover_message_bits(z_back, cfg).cpu().numpy()
        accs = [float(np.mean(v == expected)) for v in voted]
        return SweepResult(
            attack=attack, relative_strength=float(rel),
            absolute_strength=float(absolute),
            bit_accuracy_mean=float(np.mean(accs)), bit_accuracies=accs,
            tpr_at_1e6=tpr_at_fpr(accs, cfg.resolved_message_bits),
            scheduler=scheduler,
        )

    results = [row(f"none@{int(n)}step", 0.0, 0.0, images, int(n))
               for n in extract_steps_rows]
    for attack in attacks:
        for rel in ((0.0,) if attack == "none" else strengths):
            absolute = (0.0 if attack == "none"
                        else relative_strength_to_absolute(rel, attack))
            if attack == "none":
                attacked = images
            elif attack == "reversed":
                # regeneration attack (`distortions`:302-322): DDIM-invert
                # the image and re-generate, strength = step count —
                # device-native through the same pipeline
                steps = max(int(absolute), 1)
                z_regen = pipe.invert(images=images, num_steps=steps)
                attacked = pipe.generate(z_regen, guidance_scale=1.0,
                                         num_steps=steps)
            elif attack == "compression" and jpeg == "host":
                attacked = torch.from_numpy(
                    _host_jpeg(images, int(absolute))).to(device)
            else:
                g = None
                if attack in dev.RANDOMIZED and attack not in draws:
                    g = torch.Generator(device=device).manual_seed(
                        attack_seed(generator.initial_seed(), attack))
                attacked = dev.apply(images, attack, absolute, generator=g,
                                     draws=draws.get(attack))
            if attacked.shape[-2:] != images.shape[-2:]:
                # size-changing attacks (scaling): extraction always resizes
                # back to the nominal resolution first (extract.py:31-37)
                attacked = dev.resize_cubic(attacked, images.shape[-2:])
            results.append(row(attack, rel, absolute, attacked, num_steps))
    if out_jsonl:
        write_jsonlines((dataclasses.asdict(r) for r in results), out_jsonl)
    return results
