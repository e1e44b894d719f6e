"""Filename-parity alias for users arriving from the reference repo.
The gswm_torch shim reads the WebUI generation (function patch on <=1.5.2,
ImageRNG class patch on >=1.6.0) — both filenames load the same Script."""

from gswm_torch.integrations.a1111 import Script  # noqa: F401
