"""Numerical-health checks for the inversion loop (SURVEY.md §5 "race
detection / sanitizers": bf16 inversion can overflow near the schedule
edges); port of ``gswm.utils.debug``."""

from __future__ import annotations

import numpy as np
import torch


def check_finite(x, name: str = "tensor", raise_on_bad: bool = False) -> bool:
    """Host-side finite check on a (small or already-fetched) array or
    tensor; returns True when healthy, warns or raises otherwise."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    arr = np.asarray(x)
    bad = ~np.isfinite(arr)
    if not bad.any():
        return True
    frac = float(bad.mean())
    msg = (f"{name}: {bad.sum()} non-finite values ({frac:.2%}) — "
           f"min {np.nanmin(arr):.3g} max {np.nanmax(arr):.3g}")
    if raise_on_bad:
        raise FloatingPointError(msg)
    import warnings

    warnings.warn(msg, RuntimeWarning, stacklevel=2)
    return False
