"""A1111 WebUI script entry file for the PyTorch port — copy into
stable-diffusion-webui/scripts/.

Single file covering BOTH WebUI generations (the reference ships one file per
API era; gswm_torch.integrations.a1111 picks the patch point at run time and
restores the real object after each run).  Requires ``gswm_torch``
importable (pip install -e or PYTHONPATH); the watermark is embedded on the
WebUI's device.
"""

from gswm_torch.integrations.a1111 import Script  # noqa: F401
