"""Device-memory-aware batch sizing for the extraction chain (the port of
``gswm.utils.memory``), with the H100's own anchors.

The extraction chain (embed + chunked VAE encode + DDIM inversion + decode)
batches its whole inversion, which makes the batch the one memory knob.  The
model is measured on the card, not borrowed from the reference's 16 GB v5e.
The chain's peak is that of one of its two stages, each a line in the batch
``fixed + per_image * batch``:

  * ``encode``: the pipeline's weights and the VAE encoder's working set of
    one chunk of images (``InversablePipeline.vae_chunk`` scaled by the
    pixels: 32 images at 512x512, 14 at 768x768, 8 at 1024x1024), a term
    that stops growing at the chunk, plus the images themselves (float32
    and their 2x-1 copy: 6 MiB an image at 512x512);
  * ``invert``: the weights, the images and latents, and the UNet's
    activations, which grow with the whole batch (64 MiB an image at
    512x512).

A single line through the chain's peaks would be the VAE's at the batches
where its chunk dominates (17.3 to 17.8 GiB at 32 to 128 images at 512x512),
and its slope would suggest some 9,000 images where the inversion runs out
of memory at about 1,060.  ``ANCHORS_H100`` holds both lines per
architecture family and resolution, fitted by ``fit_anchor`` to
``torch.cuda.max_memory_allocated`` at three batches at or above the VAE's
chunk (``python -m gswm_torch.tools.memory_anchors``; bf16, random weights;
the peak within a step does not depend on the step count, so the sweep runs
2 inversion steps).  Below the chunk the encode line overestimates.

``suggest_batch`` interpolates each term log-linearly in the resolution
between a family's anchors (and extrapolates with the outermost pair's
exponent outside them), then takes the largest batch whose predicted peak
leaves 10% of the card free, and 2% more for the lines' error beyond the
largest batch they were fitted at.  Sizes are GiB (2**30 bytes)
throughout, as ``hbm_gb`` is.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

GiB = 2**30
# the share of the card the suggested batch's predicted peak may fill: 10%
# kept free, and 2% for the lines' extrapolation error
USABLE_SHARE = 0.88
STAGES = ("encode", "invert")

# Measured on one NVIDIA H100 80GB HBM3 (700 W): res -> {stage: (fixed GiB,
# GiB an image)} of the extraction chain per architecture family, bf16
# (tools/memory_anchors.py)
ANCHORS_H100 = {
    # sd-2-1-base at 512 (batches 32, 64, 128), sd-2-1 at 768 (16, 32, 64)
    "sd": {
        512: {"encode": (17.0823, 0.005922), "invert": (3.0373, 0.064247)},
        768: {"encode": (16.8628, 0.013308), "invert": (3.0373, 0.144351)},
    },
    # sdxl-base at 1024 (batches 8, 16, 32)
    "sdxl": {
        1024: {"encode": (22.0246, 0.023682), "invert": (7.9799, 0.198042)},
    },
}

# fp32 residency above this share of the card leaves too little for the
# inversion's activations (the reference's 6 GB of a 16 GB v5e,
# gswm/utils/memory.py:98-101, as a share)
_FP32_RESIDENCY_SHARE = 6.0 / 16.0


def card_gib(device="cuda") -> float:
    """The card's memory in GiB, as ``torch.cuda.get_device_properties``
    reports it (raises without a card)."""
    return torch.cuda.get_device_properties(torch.device(device)).total_memory / GiB


def _log_interp(res: int, anchors: dict, stage: str, index: int) -> float:
    """One term of a stage's line at ``res``: log-linear in the resolution
    between the bracketing anchors, else a power law from the nearest one
    with the exponent of the outermost pair (one anchor: the ``sd``
    family's exponent)."""
    def term(a, r):
        return a[r][stage][index]

    pts = sorted(anchors)
    below = [r for r in pts if r <= res]
    above = [r for r in pts if r >= res]
    if below and above:
        r0, r1 = max(below), min(above)
        if r0 == r1:
            return term(anchors, r0)
        t = (math.log(res) - math.log(r0)) / (math.log(r1) - math.log(r0))
        return math.exp((1 - t) * math.log(term(anchors, r0))
                        + t * math.log(term(anchors, r1)))
    outer = anchors if len(pts) > 1 else ANCHORS_H100["sd"]
    lo, hi = min(outer), max(outer)
    p = math.log(term(outer, hi) / term(outer, lo)) / math.log(hi / lo)
    r0 = min(pts, key=lambda r: abs(r - res))
    return term(anchors, r0) * (res / r0) ** p


def stage_lines(res: int, arch: str = "sd") -> dict:
    """{stage: (fixed GiB, GiB an image)} at ``res`` x ``res``."""
    anchors = ANCHORS_H100.get(arch, ANCHORS_H100["sd"])
    return {s: (_log_interp(res, anchors, s, 0), _log_interp(res, anchors, s, 1))
            for s in STAGES}


def predicted_peak_gib(res: int, batch: int, arch: str = "sd") -> float:
    """The chain's predicted peak device memory at ``batch`` images of
    ``res`` x ``res``, GiB: the larger stage's."""
    return max(fixed + batch * per for fixed, per in stage_lines(res, arch).values())


def suggest_batch(res: int, hbm_gb: Optional[float] = None,
                  requested: Optional[int] = None, arch: str = "sd",
                  device="cuda") -> int:
    """Largest batch whose predicted peak stays within ``USABLE_SHARE`` of
    ``hbm_gb`` GiB (default: the card's memory, ``card_gib(device)``),
    rounded down to a multiple of 8 (or at least 1 below 8).  ``requested``
    clamps rather than replaces: callers asking for less get what they
    asked for."""
    if hbm_gb is None:
        hbm_gb = card_gib(device)
    batch = min(int((USABLE_SHARE * hbm_gb - fixed) / per)
                for fixed, per in stage_lines(res, arch).values())
    batch = max(8, (batch // 8) * 8) if batch >= 8 else max(1, batch)
    if requested is not None:
        batch = min(batch, requested)
    return max(1, batch)


def suggest_weights_dtype(param_bytes: int, hbm_gb: Optional[float] = None,
                          device="cuda"):
    """``torch.bfloat16`` or None (keep fp32) for an fp32 parameter
    footprint, by the reference's rule (gswm/utils/memory.py:103-113): bf16
    once the fp32 parameters pass 6/16 of ``hbm_gb`` GiB (default: the
    card's memory).  The port's pipeline does not call it, as the
    reference's does on the TPU (gswm/pipelines/inversable.py:110-122): on a
    CUDA device the pipeline computes in bfloat16 only (its attention
    kernels take nothing else), so there is no fp32 residency to decide;
    ``weights_dtype`` stays the caller's choice."""
    if hbm_gb is None:
        hbm_gb = card_gib(device)
    limit = _FP32_RESIDENCY_SHARE * hbm_gb * GiB
    return torch.bfloat16 if param_bytes > limit else None


# -- measurement (tools/memory_anchors.py, chip_smoke.py) ---------------------

def module_bytes(*modules) -> int:
    """Bytes of the parameters and buffers of ``modules`` (None skipped)."""
    return sum(t.numel() * t.element_size() for m in modules if m is not None
               for t in (*m.parameters(), *m.buffers()))


def pipeline_bytes(pipe) -> int:
    """Bytes of a pipeline's own weights on its device."""
    extra = pipe.text2_projection
    return module_bytes(pipe.unet, pipe.vae, pipe.text, pipe.text2) + (
        0 if extra is None else extra.numel() * extra.element_size())


def fit_anchor(batches, peaks_gib) -> tuple[float, float]:
    """Least-squares line ``fixed + per_image * batch`` through the measured
    peaks (GiB): (fixed, per_image)."""
    n = len(batches)
    mb, mp = sum(batches) / n, sum(peaks_gib) / n
    per_image = (sum((b - mb) * (p - mp) for b, p in zip(batches, peaks_gib))
                 / sum((b - mb) ** 2 for b in batches))
    return mp - per_image * mb, per_image


def chain_peaks(pipe, cfg, batch: int, steps: int, seed: int = 0) -> dict:
    """Peak device memory (GiB) of the extraction chain at ``batch`` images:
    embed, VAE encode of images made on the card, ``steps``-step DDIM
    inversion, decode.  ``encode`` and ``invert`` are each stage's peak,
    ``chain`` the larger; each counts the pipeline's own weights and what
    the chain allocates, not what else is resident on the card.  Also
    ``images_per_s`` of the chain (host clock around synchronized work) and
    ``reserved``, the allocator's peak reservation during the inversion (all
    of the card's use, not the chain's alone)."""
    import time

    from gswm_torch.core.decode import recover_message_bits
    from gswm_torch.core.embed import embed_latents

    dev = pipe.device
    own = pipeline_bytes(pipe)
    g = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    embed_latents(cfg, generator=g, batch=batch, device=dev)
    images = torch.rand((batch, 3, cfg.height, cfg.width), generator=g, device=dev)
    latents = pipe.image_to_latents(images)
    torch.cuda.synchronize(dev)
    encode = torch.cuda.max_memory_allocated(dev) - base + own
    torch.cuda.reset_peak_memory_stats(dev)
    bits = recover_message_bits(pipe.invert(latents=latents, num_steps=steps), cfg)
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    invert = torch.cuda.max_memory_allocated(dev) - base + own
    if tuple(bits.shape) != (batch, cfg.resolved_message_bits):
        raise AssertionError(f"bits of shape {tuple(bits.shape)}")
    return {"encode": encode / GiB, "invert": invert / GiB,
            "chain": max(encode, invert) / GiB, "images_per_s": batch / seconds,
            "reserved": torch.cuda.max_memory_reserved(dev) / GiB}
