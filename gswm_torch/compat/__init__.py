"""Reference-compatibility layer of the PyTorch port: the pure-NumPy golden
re-derivations of the reference algorithms (a copy of ``gswm.compat``), the
parity oracle of the CPU tests."""

from gswm_torch.compat.numpy_reference import (  # noqa: F401
    reference_decode_numpy,
    reference_embed_numpy,
)
