"""Kernel-backed ops of the PyTorch port (see ``gswm_torch.ops.attention``)."""
