"""Mesh construction, batch sharding and the UNet's tensor-parallel layers.

The counterpart of ``gswm/sharding/mesh.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, with the JAX package's axis names and shape rules.  The
sharded functions of the port (``ops.attention.flash_attention_sharded``,
``ops.ring_attention.ring_attention``, ``ops.groupnorm.fused_group_norm_sharded``)
take a mesh explicitly; the UNet's layers take theirs from ``shard_params``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

# the backend a device type is asked for by: gloo on the CPU, NCCL on CUDA
BACKENDS = {"cpu": "gloo", "cuda": "nccl"}


def init_process_group(device_type: str, backend: Optional[str] = None, store=None,
                       rank: Optional[int] = None, world_size: Optional[int] = None) -> None:
    """Join the default process group: ``backend`` by name, else the one of
    ``device_type`` (``BACKENDS``); from ``store``, ``rank`` and
    ``world_size`` when given, else from the environment a launcher such as
    ``torchrun`` sets (``env://``).  On CUDA the process takes the card
    ``LOCAL_RANK`` names (0 without one) first."""
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    backend = backend or BACKENDS[device_type]
    if store is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)


def make_mesh(dp: Optional[int] = None, tp: int = 1, sp: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """(dp, tp[, sp]) mesh over the ranks of the default process group, which
    the caller has joined; dp defaults to world // (tp * sp).  The sp axis is
    only made when sp > 1, so two-axis callers see ("dp", "tp") as in
    gswm/sharding/mesh.py:13-31.  Raises ValueError when dp * tp * sp is not
    the world size.  Every rank calls it, in the same order (each axis is a
    new process group)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: join a process group first "
                           "(sharding.init_process_group: gloo for the CPU, nccl for CUDA)")
    n = dist.get_world_size()
    if dp is None:
        dp = n // (tp * sp)
    if dp * tp * sp != n:
        raise ValueError(f"dp*tp*sp={dp * tp * sp} != world size {n}")
    shape, names = ((dp, tp), ("dp", "tp")) if sp == 1 else ((dp, tp, sp), ("dp", "tp", "sp"))
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=names)


def axis_size(mesh: Optional[DeviceMesh], name: str) -> int:
    """The size of mesh axis ``name``; 1 without a mesh or that axis."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def batch_divisible(mesh: Optional[DeviceMesh], batch: int) -> bool:
    """Whether a ``batch`` rows are sharded over dp: dp > 1 divides them."""
    dp = axis_size(mesh, "dp")
    return dp > 1 and batch % dp == 0


def batch_sharding(mesh: DeviceMesh) -> list:
    """The placements of a batch-sharded tensor on ``mesh``: dim 0 over dp,
    replicated over the other axes (gswm/sharding/mesh.py:34-36)."""
    return [Shard(0) if name == "dp" else Replicate() for name in mesh.mesh_dim_names]


def shard_dim(x: torch.Tensor, mesh: DeviceMesh, name: str, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over mesh axis ``name``,
    contiguous."""
    n = axis_size(mesh, name)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} is not divisible by {name} = {n}")
    return x.chunk(n, dim=dim)[mesh.get_local_rank(name)].contiguous()


def gather_dim(x: torch.Tensor, mesh: DeviceMesh, name: str, dim: int) -> torch.Tensor:
    """Every rank's block along mesh axis ``name`` concatenated on ``dim``, on
    every rank: one all_gather over the axis' group."""
    parts = [torch.empty_like(x) for _ in range(axis_size(mesh, name))]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group(name))
    return torch.cat(parts, dim=dim)


def shard_batch(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's rows of a batch sharded over dp (the counterpart of
    ``device_put`` with ``batch_sharding``); raises ValueError where dp does
    not divide the batch."""
    return shard_dim(x, mesh, "dp", 0)


def gather_batch(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The whole batch on every rank from each rank's rows: an all_gather
    over dp (reading a sharded array back)."""
    return gather_dim(x, mesh, "dp", 0)


# diffusers-style names of the Megatron layers (gswm/sharding/mesh.py:43-64):
# column-parallel weights shard their (out, in) rows, row-parallel ones
# their columns; a column-parallel layer's bias goes with its rows
_COLUMN = (".to_q.weight", ".to_k.weight", ".to_v.weight", ".ff.net.0.proj.weight",
           ".ff.net.0.proj.bias")
_ROW = (".to_out.0.weight", ".ff.net.2.weight")


def _placement(name: str):
    name = "." + name
    in_attn = ".attn1." in name or ".attn2." in name
    if name.endswith(_COLUMN) and (in_attn or ".ff." in name):
        return Shard(0)
    if name.endswith(_ROW) and (in_attn or ".ff." in name):
        return Shard(1)
    return Replicate()


def unet_param_specs(unet: nn.Module) -> dict:
    """Parameter name -> tensor-parallel placement over tp: ``Shard(0)``
    (column-parallel: attn1/attn2 to_q, to_k, to_v and GEGLU's
    ff.net.0.proj, whose bias shards with its rows), ``Shard(1)``
    (row-parallel: to_out.0 and ff.net.2, whose biases stay whole and are
    added once after the sum), ``Replicate()`` for everything else."""
    return {name: _placement(name) for name, _ in unet.named_parameters()}


def _slice_rows(linear: nn.Linear, rows: torch.Tensor) -> None:
    linear.weight = nn.Parameter(linear.weight.data[rows].contiguous(), requires_grad=False)
    if linear.bias is not None:
        linear.bias = nn.Parameter(linear.bias.data[rows].contiguous(), requires_grad=False)
    linear.out_features = len(rows)


def _slice_columns(linear: nn.Linear, cols: slice) -> None:
    linear.weight = nn.Parameter(linear.weight.data[:, cols].contiguous(), requires_grad=False)
    linear.in_features = cols.stop - cols.start


def shard_params(unet: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Tensor- and sequence-parallel UNet on ``mesh``, in place (the
    counterpart of gswm/sharding/mesh.py:78-83, with GSPMD's collectives made
    explicit):

      * every ``Attention`` whose heads tp divides keeps rank r's heads: rows
        of to_q/to_k/to_v, columns of to_out.0 (``unet_param_specs``); its
        to_out.0 output is summed over tp and its bias added once, after;
      * every ``FeedForward`` whose width tp divides keeps rank r's block of
        GEGLU's two halves, rows [h block r; gate block r] of ff.net.0.proj
        (a contiguous block would give rank 0 all of h and no gate), and the
        columns of ff.net.2 under h block r;
      * a layer tp does not divide (sd-2-1's 5 heads at level 0) keeps its
        weights whole and runs no collective, where the JAX kernel falls back
        (attention.py:1522-1523);
      * every ``Attention`` records whether the mesh's tp or sp is above 1
        (self-attention then takes the split or plain route) and, with
        sp > 1, the sp sub-mesh its self-attention rings over.

    The UNet must hold the same weights on every rank (``replicate``)."""
    from gswm_torch.models.layers import Attention, FeedForward

    tp, sp = axis_size(mesh, "tp"), axis_size(mesh, "sp")
    r = mesh.get_local_rank("tp") if tp > 1 else 0
    group = mesh.get_group("tp") if tp > 1 else None
    for module in unet.modules():
        if isinstance(module, Attention):
            module.sharded = tp > 1 or sp > 1
            module.sp_mesh = mesh["sp"] if sp > 1 else None
            if tp > 1 and module.heads % tp == 0:
                width = module.heads * module.head_dim // tp
                rows = torch.arange(r * width, (r + 1) * width)
                for lin in (module.to_q, module.to_k, module.to_v):
                    _slice_rows(lin, rows)
                _slice_columns(module.to_out[0], slice(r * width, (r + 1) * width))
                module.local_heads = module.heads // tp
                module.tp_group = group
        elif isinstance(module, FeedForward):
            proj, out = module.net[0].proj, module.net[2]
            inner = proj.out_features // 2
            if tp > 1 and inner % tp == 0:
                w = inner // tp
                rows = torch.cat([torch.arange(r * w, (r + 1) * w),
                                  inner + torch.arange(r * w, (r + 1) * w)])
                _slice_rows(proj, rows)
                _slice_columns(out, slice(r * w, (r + 1) * w))
                module.tp_group = group
    return unet


def replicate(module: nn.Module, src: int = 0) -> nn.Module:
    """Every parameter and buffer of ``module`` broadcast from global rank
    ``src``, in place: the same weights on every rank (the counterpart of
    ``device_put`` with a replicated sharding)."""
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=src)
    return module
