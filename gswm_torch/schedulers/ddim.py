"""DDIM and exact DDIM inversion (eta = 0) — port of ``gswm.schedulers.ddim``.

The closed-form update is symmetric in (alpha_from, alpha_to), so one
``ddim_step`` serves generation and inversion; only the per-step plan
differs.  Inversion replays the generation pairs in reverse with alphas
swapped and evaluates the model at the *target* (higher) timestep, the
convention of diffusers' DDIMInverseScheduler.  All state and coefficients are
float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gswm_torch.schedulers.schedule import NoiseSchedule


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """Per-step float32 arrays the pipeline's step loop walks.

    t_model/alpha_eval: where the UNet is evaluated.
    alpha_from/alpha_to: the state transition.
    extras: scheduler-specific per-step arrays (DPM's first-order flags).
    """

    t_model: np.ndarray  # (N,) int32
    alpha_eval: np.ndarray  # (N,) float32
    alpha_from: np.ndarray  # (N,) float32
    alpha_to: np.ndarray  # (N,) float32
    extras: dict = dataclasses.field(default_factory=dict)


def to_eps(x, model_out, alpha_eval, prediction_type: str = "epsilon"):
    """Convert a model output to an epsilon prediction.

    For v-prediction (SD 2.1-768): eps = sqrt(a) v + sqrt(1-a) x, with a at
    the model-eval timestep.
    """
    if prediction_type == "epsilon":
        return model_out
    if prediction_type == "v_prediction":
        return torch.sqrt(alpha_eval) * model_out + torch.sqrt(1.0 - alpha_eval) * x
    raise ValueError(prediction_type)


def pred_x0(x, eps, alpha):
    return (x - torch.sqrt(1.0 - alpha) * eps) / torch.sqrt(alpha)


def ddim_step(x, eps, alpha_from, alpha_to):
    """One DDIM transition alpha_from -> alpha_to (either direction).
    Alphas are 0-d float32 tensors on x's device."""
    x0 = pred_x0(x, eps, alpha_from)
    return torch.sqrt(alpha_to) * x0 + torch.sqrt(1.0 - alpha_to) * eps


def ddim_plan(schedule: NoiseSchedule, num_steps: int) -> StepPlan:
    """Generation: descending timesteps; model eval at the source timestep."""
    ts = schedule.timesteps(num_steps)  # descending
    ratio = schedule.num_train_timesteps // num_steps
    a_from = schedule.alpha_at(ts).astype(np.float32)
    return StepPlan(
        t_model=ts.astype(np.int32),
        alpha_eval=a_from,
        alpha_from=a_from,
        alpha_to=schedule.alpha_at(ts - ratio).astype(np.float32),
    )


def ddim_inverse_plan(schedule: NoiseSchedule, num_steps: int) -> StepPlan:
    """Inversion: mirrored pairs, ascending, model eval at the target."""
    ts = schedule.timesteps(num_steps)  # descending
    ratio = schedule.num_train_timesteps // num_steps
    ts_asc = ts[::-1]
    a_to = schedule.alpha_at(ts_asc).astype(np.float32)
    return StepPlan(
        t_model=ts_asc.astype(np.int32),
        alpha_eval=a_to,
        alpha_from=schedule.alpha_at((ts - ratio)[::-1]).astype(np.float32),
        alpha_to=a_to,
    )

