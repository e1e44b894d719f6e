"""The benchmark of gswm_torch on one NVIDIA H100: see README.md."""
