"""Training noise schedule (beta/alpha tables) + timestep spacing.

Stable Diffusion's scheduler config: scaled_linear betas 0.00085..0.012 over
1000 steps, leading spacing with steps_offset=1, set_alpha_to_one=False —
so the "alpha before time zero" is alphas_cumprod[0] (the diffusers
``final_alpha_cumprod`` the recovered pyc also uses, SURVEY.md §2.3).
All tables are small (1000,) float64 numpy arrays computed on host once; the
per-run plans gather from them and ship (steps,)-shaped float32 arrays to
device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    num_train_timesteps: int
    alphas_cumprod: np.ndarray  # (T,) float64
    final_alpha_cumprod: float
    prediction_type: str = "epsilon"  # or "v_prediction" (SD 2.1-768)
    steps_offset: int = 1

    def timesteps(self, num_steps: int) -> np.ndarray:
        """Descending generation timesteps, diffusers 'leading' spacing:
        (arange(N) * (T // N)).round()[::-1] + steps_offset."""
        ratio = self.num_train_timesteps // num_steps
        ts = (np.arange(num_steps) * ratio).round()[::-1].astype(np.int64)
        ts = ts + self.steps_offset
        return np.clip(ts, 0, self.num_train_timesteps - 1)

    def alpha_at(self, t: np.ndarray) -> np.ndarray:
        """alphas_cumprod[t], with t < 0 mapping to final_alpha_cumprod."""
        t = np.asarray(t)
        safe = np.clip(t, 0, self.num_train_timesteps - 1)
        a = self.alphas_cumprod[safe]
        return np.where(t < 0, self.final_alpha_cumprod, a)


def sd_schedule(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "scaled_linear",
    prediction_type: str = "epsilon",
    set_alpha_to_one: bool = False,
    steps_offset: int = 1,
) -> NoiseSchedule:
    if beta_schedule == "scaled_linear":
        betas = (
            np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps) ** 2
        )
    elif beta_schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps)
    else:
        raise ValueError(f"unknown beta_schedule {beta_schedule!r}")
    alphas_cumprod = np.cumprod(1.0 - betas)
    final = 1.0 if set_alpha_to_one else float(alphas_cumprod[0])
    return NoiseSchedule(
        num_train_timesteps=num_train_timesteps,
        alphas_cumprod=alphas_cumprod,
        final_alpha_cumprod=final,
        prediction_type=prediction_type,
        steps_offset=steps_offset,
    )
