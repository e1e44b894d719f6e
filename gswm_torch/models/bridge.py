"""Weight bridge: the JAX package's flax parameter trees -> the port's
``state_dict``s.

The inverse of ``gswm.models.loader``'s diffusers -> flax conversion.  Input
trees are nested dicts whose leaves are arrays (numpy, or anything
``np.asarray`` takes); this module imports neither jax nor flax.

Rules, applied per leaf:
  * path segments ``<name>_<i>`` of the list modules (``down_blocks_0``,
    ``resnets_1``, ...) -> ``<name>.<i>``; ``to_out`` -> ``to_out.0``;
    ``ff/net_0`` -> ``ff.net.0``, ``ff/net_2`` -> ``ff.net.2``;
  * ``kernel`` of rank 4 (conv, HWIO) -> ``weight`` (OIHW);
    ``kernel`` of rank 2 (dense, (in, out)) -> ``weight`` (out, in);
  * ``scale`` (norms) -> ``weight``; ``embedding`` -> ``weight``.
Every converted key must exist in the target model and every model key must
be converted, with equal shapes: anything left over on either side raises.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

_LIST_MODULES = re.compile(
    r"^(down_blocks|up_blocks|resnets|attentions|transformer_blocks|"
    r"downsamplers|upsamplers|net)_(\d+)$")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):  # dict, FrozenDict
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _convert_leaf(path: tuple[str, ...], value) -> tuple[str, np.ndarray]:
    arr = np.asarray(value, dtype=np.float32)
    *mods, leaf = path
    names = []
    for m in mods:
        hit = _LIST_MODULES.match(m)
        if hit:
            names += [hit.group(1), hit.group(2)]
        elif m == "to_out":
            names += ["to_out", "0"]
        else:
            names.append(m)
    if leaf == "kernel":
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif arr.ndim == 2:
            arr = arr.T  # (in, out) -> (out, in)
        else:
            raise ValueError(f"kernel of rank {arr.ndim} at {'/'.join(path)}")
        leaf = "weight"
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    elif leaf != "bias":
        raise ValueError(f"unknown parameter {'/'.join(path)}")
    return ".".join(names + [leaf]), np.array(arr, order="C")  # own copy


def convert_tree(tree) -> dict[str, torch.Tensor]:
    """Flax tree -> flat {torch name: float32 tensor}."""
    if "params" in tree and len(tree) == 1:
        tree = tree["params"]
    out = {}
    for path, value in _flatten(tree):
        name, arr = _convert_leaf(path, value)
        if name in out:
            raise ValueError(f"two flax leaves map to {name}")
        out[name] = torch.from_numpy(arr)
    return out


def load_tree_(module: nn.Module, tree) -> nn.Module:
    """Copy a flax tree into ``module`` (in place); raise on keys left over
    on either side or on a shape mismatch."""
    converted = convert_tree(tree)
    target = module.state_dict()
    missing = sorted(set(target) - set(converted))
    unexpected = sorted(set(converted) - set(target))
    if missing or unexpected:
        raise ValueError(f"bridge mismatch: missing {missing[:20]}, "
                         f"unexpected {unexpected[:20]}")
    for name, t in converted.items():
        if tuple(t.shape) != tuple(target[name].shape):
            raise ValueError(f"bridge shape {name}: {tuple(t.shape)} vs "
                             f"{tuple(target[name].shape)}")
    module.load_state_dict(converted, strict=True)
    return module


def load_pipeline_params_(pipe, unet_params, vae_params, text_params):
    """Load the JAX pipeline's unet/vae/text trees into a port pipeline
    (the whole VAE: encoder, decoder and both quant convs)."""
    load_tree_(pipe.unet, unet_params)
    load_tree_(pipe.vae, vae_params)
    load_tree_(pipe.text, text_params)
    pipe.reset_caches()
    return pipe
