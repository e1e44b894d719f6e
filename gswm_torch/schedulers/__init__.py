"""Diffusion schedulers of the PyTorch port: host-side numpy plans plus pure
float32 steps, DDIM and DPM++ 2M."""

from gswm_torch.schedulers.schedule import NoiseSchedule, sd_schedule  # noqa: F401
from gswm_torch.schedulers.ddim import (  # noqa: F401
    ddim_inverse_plan,
    ddim_plan,
    ddim_step,
)
from gswm_torch.schedulers.dpm import (  # noqa: F401
    dpm_inverse_plan,
    dpm_plan,
    dpm_step,
)

# name -> (generation plan, inversion plan), gswm/schedulers/__init__.py:23
SCHEDULERS = {
    "DDIM": (ddim_plan, ddim_inverse_plan),
    "DPMs": (dpm_plan, dpm_inverse_plan),
}
