"""DPM-Solver++ 2M (multistep) and its inverse — port of
``gswm.schedulers.dpm``.

The update is direction agnostic in log-SNR space, so one ``dpm_step``
serves generation (plan descending) and inversion (plan ascending):

    lam(a)  = 0.5 * log(a / (1-a))
    h       = lam_t - lam_s0
    first:  x_t = (sig_t/sig_s0) x - alp_t (exp(-h)-1) m0
    second: D1  = (m0 - m1) / r0,  r0 = (lam_s0 - lam_s1) / h
            x_t = (sig_t/sig_s0) x - alp_t (exp(-h)-1) (m0 + 0.5 D1)

with alp = sqrt(a), sig = sqrt(1-a) and m0/m1 the current/previous predicted
x0.  The step loop is a Python loop here, so the order flags are host bools:
``first_order`` comes from the plan and ``have_prev`` rides in the carry, and
the second-order term is computed only when it is used (the JAX scan computes
both and selects).  State and coefficients are float32.
"""

from __future__ import annotations

import numpy as np
import torch

from gswm_torch.schedulers.ddim import StepPlan, pred_x0
from gswm_torch.schedulers.schedule import NoiseSchedule


def _lam(alpha):
    return 0.5 * torch.log(alpha / (1.0 - alpha))


def dpm_step(x, eps, alpha_from, alpha_to, carry, first_order: bool):
    """One DPM++ 2M transition.  ``carry`` = (prev_x0, prev_lambda,
    have_prev); ``eps`` is an epsilon prediction (convert v outputs with
    ``ddim.to_eps`` first); alphas are 0-d float32 tensors on x's device.
    Returns (x_next, new_carry)."""
    prev_x0, prev_lam, have_prev = carry
    x0 = pred_x0(x, eps, alpha_from)

    lam_s = _lam(alpha_from)
    h = _lam(alpha_to) - lam_s
    alp_t = torch.sqrt(alpha_to)
    ratio = torch.sqrt(1.0 - alpha_to) / torch.sqrt(1.0 - alpha_from)
    phi = torch.expm1(-h)

    if first_order or not have_prev:
        x_next = ratio * x - alp_t * phi * x0
    else:
        r0 = (lam_s - prev_lam) / h
        d1 = (x0 - prev_x0) / torch.where(r0 == 0, 1.0, r0)
        x_next = ratio * x - alp_t * phi * (x0 + 0.5 * d1)
    return x_next, (x0, lam_s, True)


def dpm_init_carry(shape, device=None):
    return (torch.zeros(shape, dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.float32, device=device), False)


def _first_order_flags(n: int, lower_order_final: bool) -> np.ndarray:
    flags = np.zeros(n, dtype=bool)
    flags[0] = True  # no previous model output yet
    if lower_order_final and n > 1:
        flags[-1] = True
    return flags


def dpm_plan(schedule: NoiseSchedule, num_steps: int) -> StepPlan:
    """Generation: diffusers DPMSolverMultistepScheduler semantics — 'linspace'
    timesteps ``linspace(0, T-1, N+1).round()`` descending without the
    trailing 0, the last transition to sigma = 0 (alpha_to = 1), lower order
    on the final step, model eval at the source timestep."""
    T = schedule.num_train_timesteps
    ts = np.linspace(0, T - 1, num_steps + 1).round().astype(np.int64)
    ts = ts[::-1][:-1].copy()  # descending, N values
    a_from = schedule.alpha_at(ts).astype(np.float32)
    return StepPlan(
        t_model=ts.astype(np.int32),
        alpha_eval=a_from,
        alpha_from=a_from,
        alpha_to=np.concatenate([schedule.alpha_at(ts[1:]), [1.0]]).astype(
            np.float32),
        extras={"first_order": _first_order_flags(num_steps,
                                                  lower_order_final=True)},
    )


def dpm_inverse_plan(schedule: NoiseSchedule, num_steps: int) -> StepPlan:
    """Inversion: diffusers DPMSolverMultistepInverseScheduler semantics —
    ascending 'linspace' timesteps ``linspace(0, T-1, N+1).round()[:-1]``,
    the final transition to T-1, model eval at the SOURCE timestep, lower
    order on the final step only below 15 steps."""
    T = schedule.num_train_timesteps
    ts = np.linspace(0, T - 1, num_steps + 1).round().astype(np.int64)
    ts_asc = ts[:-1].copy()  # ascending, N values; final target is T-1
    a_from = schedule.alpha_at(ts_asc).astype(np.float32)
    return StepPlan(
        t_model=ts_asc.astype(np.int32),
        alpha_eval=a_from,
        alpha_from=a_from,
        alpha_to=schedule.alpha_at(ts[1:]).astype(np.float32),
        extras={"first_order": _first_order_flags(
            num_steps, lower_order_final=num_steps < 15)},
    )
