"""Fit a random-init VAE so encode approximately inverts decode; port of
``gswm.utils.fitting``.

Without real SD weights a *random* VAE destroys latents entirely, and any
image-space roundtrip accuracy above chance would be seed luck.  A real SD
VAE is near-lossless for the posterior mean, so Adam on
``encode(clip(decode(z))) ~= z`` over the latent scales the pipeline
produces puts a VAE in the same regime: closed loops through image space
(tests, robustness sweeps) then measure the extraction chain, not luck.

The fit runs no hand-written kernel, by the JAX package's own design: no
kernel of either package has a backward.  It sets ``GSWM_VAE_ATTN=chunked``
(the mid attention in plain PyTorch, a chunk of queries at a time) and
``GSWM_VAE_REMAT=block`` (each encoder and decoder block checkpointed) for
its duration, and the kernel wrappers refuse a gradient
(``native.refuse_grad``).
"""

from __future__ import annotations

import contextlib
import copy
import os
from typing import Optional

import torch
import torch.nn.functional as F

# the two switches the fit sets, and what it sets them to
FIT_SWITCHES = {"GSWM_VAE_ATTN": "chunked", "GSWM_VAE_REMAT": "block"}


def _ring_index(h: int, w: int, nbins: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(radius (h, w//2+1), ring index (h, w//2+1)) of the rfft2 grid: the
    spatial frequency's radius, cut into ``nbins`` rings of equal width."""
    fy = torch.fft.fftfreq(h, device=device)[:, None]
    fx = torch.fft.rfftfreq(w, device=device)[None, :]
    r = torch.sqrt(fy**2 + fx**2)
    idx = torch.clamp((r / r.max() * nbins).to(torch.int32), 0, nbins - 1)
    return r, idx.long()


def radial_logpsd(img: torch.Tensor, nbins: int = 16) -> torch.Tensor:
    """Per-image radial log power spectrum, ``nbins`` rings over spatial
    frequency (rfft2 over H, W; channels pooled).  Returns (B, nbins)
    (gswm/utils/fitting.py:18-33)."""
    h, w = img.shape[-2:]
    p = torch.fft.rfft2(img.to(torch.float32)).abs() ** 2
    _, idx = _ring_index(h, w, nbins, img.device)
    onehot = F.one_hot(idx, nbins).to(torch.float32)
    psd = (torch.einsum("bchw,hwn->bn", p, onehot)
           / (onehot.sum(dim=(0, 1)) + 1e-9) / img.shape[1])
    return torch.log(psd + 1e-12)


def spectral_loss(img: torch.Tensor, alpha: float = 2.0, nbins: int = 16) -> torch.Tensor:
    """Shape mismatch between the decoded images' radial spectrum and the
    natural-image 1/f^alpha law, both mean-centred in log space, the DC ring
    left out: only the allocation across bands is constrained
    (gswm/utils/fitting.py:36-61).  The identity objective alone selects the
    smoothest information channel; this term is a natural-image prior that
    owes nothing to any attack."""
    h, w = img.shape[-2:]
    r, idx = _ring_index(h, w, nbins, img.device)
    centers = torch.stack([
        torch.where(idx == n, r, 0.0).sum() / torch.clamp((idx == n).sum(), min=1)
        for n in range(nbins)])
    target = -alpha * torch.log(centers[1:] + 1e-12)
    target = target - target.mean()
    logpsd = radial_logpsd(img, nbins)[:, 1:]
    logpsd = logpsd - logpsd.mean(dim=1, keepdim=True)
    return torch.mean((logpsd - target[None, :]) ** 2)


def roundtrip_loss(vae, z: torch.Tensor, scale: torch.Tensor,
                   spectral: float = 0.0) -> torch.Tensor:
    """``mean(((encode(clip(decode(z), -1, 1)) - z) / scale)^2)``, plus
    ``spectral * spectral_loss`` of the clipped images: the JAX package's
    ``loss_fn`` (gswm/utils/fitting.py:97-103).  ``scale`` broadcasts
    against ``z`` ((B, 1, 1, 1))."""
    img = torch.clamp(vae.decode(z), -1.0, 1.0)  # generate() clips images
    z_back = vae.encode(img)
    loss = torch.mean(((z_back - z) / scale) ** 2)
    if spectral > 0.0:
        loss = loss + spectral * spectral_loss(img)
    return loss


@contextlib.contextmanager
def fit_switches():
    """``FIT_SWITCHES`` set in the environment, the previous values restored
    on the way out."""
    saved = {name: os.environ.get(name) for name in FIT_SWITCHES}
    os.environ.update(FIT_SWITCHES)
    try:
        yield
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


def _is_fp32(module) -> bool:
    return all(p.dtype == torch.float32 for p in module.parameters()
               if p.is_floating_point())


def fit_vae_roundtrip(pipe_or_vae, scale_range=(8.0, 18.0), steps: int = 600,
                      batch: int = 16, lr: float = 1e-3,
                      generator: Optional[torch.Generator] = None,
                      latent_hw=(8, 8), spectral: float = 0.0, draws=None) -> dict:
    """Train a VAE so encode inverts decode at the latent scales the
    pipeline produces (gswm/utils/fitting.py:64-150).  Takes a pipeline
    (its ``.vae``) or an ``AutoencoderKL``, on its own device; returns the
    fitted float32 ``state_dict``.

    ``scale_range`` matters: a random epsilon-UNet's DDIM trajectory
    telescopes x0 ~ x_T / sqrt(alpha_T), about 14x the unit-Gaussian scale
    (real UNets cancel the noise, random ones do not), so the fit covers
    that regime for closed-loop runs.

    Each step draws ``scale`` ~ U(scale_range) of shape (batch, 1, 1, 1)
    and ``z = scale * N(0, 1)`` of shape (batch, latent_channels, *latent_hw)
    from ``generator`` (default: seed 42 on the VAE's device), or takes
    step i's ``(z, scale)`` from ``draws`` (then ``steps`` is
    ``len(draws)``).

    Precision: Adam's state and the parameters it updates are float32, the
    master copy.  A module whose floating parameters are all float32 is
    that copy and is trained in place; any other (a pipeline's bf16 VAE) is
    trained through a float32 copy, and the result is loaded back, which
    rounds it to each parameter's own dtype (the norms stay float32, as
    ``to_compute_dtype_`` keeps them).  On a CUDA device the forward and
    backward run under ``torch.autocast`` in bfloat16: convolutions and
    matmuls take bf16 operands with fp32 accumulation and return bf16, the
    norms compute in fp32.  That is the JAX fit's own arithmetic (flax
    ``dtype=bf16`` over float32 parameters, tools/fit_sd21_vae.py:110):
    each weight rounded to bf16 at its use, never in its stored copy, so
    the late stages' updates at lr 1e-4, below half a bf16 ulp of most
    weights, still accumulate.  On the CPU the fit runs in float32.

    The optimiser is ``torch.optim.Adam`` with its defaults, which are
    optax.adam's (beta 0.9 / 0.999, eps 1e-8 added outside the square
    root).  The fit calls ``vae.encode`` / ``vae.decode`` itself: the
    pipeline's methods run under inference mode, whose tensors autograd
    cannot take.  ``requires_grad`` is on for the fit's duration only, and
    ``fit_switches`` hold for it."""
    vae = getattr(pipe_or_vae, "vae", pipe_or_vae)
    master = vae if _is_fp32(vae) else copy.deepcopy(vae).float()
    device = next(master.parameters()).device
    c = master.config.latent_channels
    h, w = latent_hw
    if draws is not None:
        steps = len(draws)
    elif generator is None:
        generator = torch.Generator(device=device).manual_seed(42)
    autocast = (torch.autocast("cuda", dtype=torch.bfloat16) if device.type == "cuda"
                else contextlib.nullcontext())
    try:
        master.requires_grad_(True)
        opt = torch.optim.Adam(master.parameters(), lr=lr)
        with fit_switches(), torch.enable_grad():
            for i in range(steps):
                if draws is not None:
                    z, scale = (torch.as_tensor(t).to(device, torch.float32)
                                for t in draws[i])
                else:
                    scale = torch.empty((batch, 1, 1, 1), device=device).uniform_(
                        scale_range[0], scale_range[1], generator=generator)
                    z = scale * torch.randn((batch, c, h, w), device=device,
                                            generator=generator)
                with autocast:
                    loss = roundtrip_loss(master, z, scale, spectral)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
    finally:
        master.requires_grad_(False)
    state = {k: v.detach().to(torch.float32, copy=True)
             for k, v in master.state_dict().items()}
    if master is not vae:
        vae.load_state_dict(state)  # rounds into each parameter's own dtype
    if vae is not pipe_or_vae and hasattr(pipe_or_vae, "weights_loaded_"):
        pipe_or_vae.weights_loaded_()
    return state

