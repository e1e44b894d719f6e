"""Diffusion schedulers of the PyTorch port: host-side numpy plans plus a pure
float32 ``ddim_step``.  DPM++ waits for a later slice."""

from gswm_torch.schedulers.schedule import NoiseSchedule, sd_schedule  # noqa: F401
from gswm_torch.schedulers.ddim import (  # noqa: F401
    ddim_inverse_plan,
    ddim_plan,
    ddim_step,
)
