"""State cache: a converted checkpoint component saved once, reloaded fast.

Port of ``gswm.models.cache``.  The key is the JAX package's: sha256 of
``"{model_dir}:{mtime}"`` (mtime "0" where the directory cannot be read),
16 hex digits, one file ``{component}_{digest}.pt`` a component, written
through ``torch.save`` to a temporary name and moved into place atomically,
read back with ``torch.load(weights_only=True)`` (tensors and plain
containers only).
"""

from __future__ import annotations

import hashlib
import os

import torch


def cache_path(cache_dir: str, model_dir: str, component: str) -> str:
    # os.path.exists is False exactly where the stat under getmtime fails
    stamp = str(os.path.getmtime(model_dir)) if os.path.exists(model_dir) else "0"
    digest = hashlib.sha256(f"{model_dir}:{stamp}".encode()).hexdigest()[:16]
    return os.path.join(cache_dir, f"{component}_{digest}.pt")


def save_state(state, cache_dir: str, model_dir: str, component: str) -> str:
    os.makedirs(cache_dir, exist_ok=True)
    path = cache_path(cache_dir, model_dir, component)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def load_state(cache_dir: str, model_dir: str, component: str):
    """The cached state, or None on a miss."""
    path = cache_path(cache_dir, model_dir, component)
    if not os.path.exists(path):
        return None
    return torch.load(path, weights_only=True)


def load_or_convert(cache_dir: str, model_dir: str, component: str, convert_fn):
    """Cache-through: the cached state if present, else ``convert_fn()``,
    saved before it is returned."""
    cached = load_state(cache_dir, model_dir, component)
    if cached is not None:
        return cached
    state = convert_fn()
    save_state(state, cache_dir, model_dir, component)
    return state
