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
``convert_shapes`` applies the same rules to a tree of shapes alone (leaves
with a ``.shape``, as ``jax.eval_shape`` gives them), so a full-size model's
names and shapes can be held against the JAX package's without its arrays.
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


def _convert_path(path: tuple[str, ...], ndim: int) -> tuple[str, tuple | None]:
    """(torch name, axis permutation from the flax layout or None)."""
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
    perm = None
    if leaf == "kernel":
        if ndim == 4:
            perm = (3, 2, 0, 1)  # HWIO -> OIHW
        elif ndim == 2:
            perm = (1, 0)  # (in, out) -> (out, in)
        else:
            raise ValueError(f"kernel of rank {ndim} at {'/'.join(path)}")
        leaf = "weight"
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    elif leaf != "bias":
        raise ValueError(f"unknown parameter {'/'.join(path)}")
    return ".".join(names + [leaf]), perm


def _convert(tree, leaf_fn) -> dict:
    if "params" in tree and len(tree) == 1:
        tree = tree["params"]
    out = {}
    for path, value in _flatten(tree):
        shape = value.shape if hasattr(value, "shape") else np.shape(value)
        name, perm = _convert_path(path, len(shape))
        if name in out:
            raise ValueError(f"two flax leaves map to {name}")
        out[name] = leaf_fn(value, perm)
    return out


def convert_tree(tree) -> dict[str, torch.Tensor]:
    """Flax tree -> flat {torch name: float32 tensor}."""
    def leaf(value, perm):
        arr = np.asarray(value, dtype=np.float32)
        if perm is not None:
            arr = arr.transpose(perm)
        return torch.from_numpy(np.array(arr, order="C"))  # own copy

    return _convert(tree, leaf)


def convert_shapes(tree) -> dict[str, tuple]:
    """Flax tree of shapes (any leaf with ``.shape``) -> {torch name:
    shape}, by ``convert_tree``'s rules."""
    return _convert(tree, lambda value, perm: tuple(
        value.shape[i] for i in (perm or range(len(value.shape)))))


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


def load_pipeline_params_(pipe, unet_params, vae_params, text_params,
                          text2_params=None, text2_projection=None):
    """Load the JAX pipeline's unet/vae/text trees into a port pipeline
    (the whole VAE: encoder, decoder and both quant convs); for SDXL also
    its second encoder's tree (``jpipe.text2.params`` for random weights,
    ``jpipe.text2_params`` for a checkpoint's) and the (in, out)
    ``text2_projection`` array, or None."""
    load_tree_(pipe.unet, unet_params)
    load_tree_(pipe.vae, vae_params)
    load_tree_(pipe.text, text_params)
    if (pipe.text2 is None) != (text2_params is None):
        raise ValueError("text2_params must be given exactly when the pipeline has "
                         "a second text encoder")
    if text2_params is not None:
        load_tree_(pipe.text2, text2_params)
    pipe.text2_projection = None if text2_projection is None else torch.from_numpy(
        np.array(text2_projection, dtype=np.float32)).to(pipe.device)
    pipe.weights_loaded_()
    return pipe


# CLIP's leaves outside the rules above: the vision tower's class embedding
# (a bare vector) and the scalar logit scale keep their names
_CLIP_BARE_LEAVES = {("vision_model", "embeddings", "class_embedding"):
                     "vision_model.embeddings.class_embedding",
                     ("logit_scale",): "logit_scale"}


def clip_from_flax(params, config):
    """``FlaxCLIPModel``'s parameter tree (nested dicts of arrays, numpy or
    anything ``np.asarray`` takes) -> a float32 ``models.clip.ClipModel`` of
    ``config`` (a ``ClipConfig`` or a transformers config.json dict) on the
    CPU; raises on keys left over on either side or on a shape mismatch."""
    from gswm_torch.models import clip, loader

    if "params" in params and len(params) == 1:
        params = params["params"]
    bare, rest = {}, {}
    for path, value in _flatten(params):
        if path in _CLIP_BARE_LEAVES:
            bare[_CLIP_BARE_LEAVES[path]] = torch.from_numpy(
                np.array(value, dtype=np.float32))
            continue
        node = rest
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    cfg = config if isinstance(config, clip.ClipConfig) else clip.config_from_dict(config)
    with torch.device("meta"):
        model = clip.ClipModel(cfg)
    loader.load_state_(model, {**convert_tree(rest), **bare}, "CLIP")
    return model.eval().requires_grad_(False)
