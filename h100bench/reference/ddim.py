"""DDIM (eta = 0) and its exact inversion, in float32: the scheduler of
Stable Diffusion's published configs (scaled-linear betas, "leading"
timestep spacing, ``set_alpha_to_one`` false) and diffusers'
DDIMInverseScheduler convention (inversion evaluates the model at the
target timestep)."""

from __future__ import annotations

import numpy as np
import torch


def alphas_cumprod(sched: dict) -> np.ndarray:
    n = sched["num_train_timesteps"]
    if sched["beta_schedule"] != "scaled_linear":
        raise ValueError(f"beta schedule {sched['beta_schedule']!r}")
    betas = np.linspace(sched["beta_start"] ** 0.5, sched["beta_end"] ** 0.5, n) ** 2
    return np.cumprod(1.0 - betas)


def plan(sched: dict, steps: int, invert: bool):
    """(timesteps, alpha at the model's evaluation, alpha from, alpha to),
    one entry a step in the order the loop walks them."""
    n = sched["num_train_timesteps"]
    ac = alphas_cumprod(sched)
    final = 1.0 if sched["set_alpha_to_one"] else float(ac[0])

    def alpha(t):
        t = np.asarray(t)
        return np.where(t < 0, final, ac[np.clip(t, 0, n - 1)]).astype(np.float32)

    ratio = n // steps
    ts = np.clip((np.arange(steps) * ratio).round()[::-1].astype(np.int64)
                 + sched["steps_offset"], 0, n - 1)
    if not invert:
        return ts, alpha(ts), alpha(ts), alpha(ts - ratio)
    asc = ts[::-1]
    return asc, alpha(asc), alpha((ts - ratio)[::-1]), alpha(asc)


def step(x, eps, a_from, a_to):
    """One DDIM transition from alpha ``a_from`` to ``a_to``, either way."""
    x0 = (x - torch.sqrt(1.0 - a_from) * eps) / torch.sqrt(a_from)
    return torch.sqrt(a_to) * x0 + torch.sqrt(1.0 - a_to) * eps


def run(unet, x, context, sched: dict, steps: int, invert: bool, added=None,
        uncond=None, guidance: float = 1.0, prediction: str = "epsilon"):
    """The DDIM loop on float32 latents ``x``. With ``uncond`` each step
    evaluates the UNet on the (uncond, cond) pair and guides its output
    out_u + g (out_c - out_u); ``added`` is doubled with it. A
    v-prediction output becomes eps = sqrt(a) v + sqrt(1 - a) x."""
    ts, a_eval, a_from, a_to = plan(sched, steps, invert)
    dev = x.device
    x = x.float()
    guided = uncond is not None
    ctx = torch.cat([uncond, context]) if guided else context
    if guided and added is not None:
        added = {k: torch.cat([v, v]) for k, v in added.items()}
    for i, t in enumerate(ts.tolist()):
        tt = torch.full((), t, dtype=torch.int32, device=dev)
        if guided:
            out_u, out_c = unet(torch.cat([x, x]), tt, ctx, added).chunk(2)
            eps = out_u + guidance * (out_c - out_u)
        else:
            eps = unet(x, tt, ctx, added)
        if prediction == "v_prediction":
            a = torch.tensor(a_eval[i], device=dev)
            eps = torch.sqrt(a) * eps + torch.sqrt(1.0 - a) * x
        elif prediction != "epsilon":
            raise ValueError(f"prediction type {prediction!r}")
        x = step(x, eps, torch.tensor(a_from[i], device=dev), torch.tensor(a_to[i], device=dev))
    return x
