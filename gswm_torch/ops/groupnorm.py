"""Fused GroupNorm (+ SiLU): the port's counterpart of the JAX package's
``gswm.ops.groupnorm.fused_group_norm`` Pallas op.

The JAX package exports the op but does not route its model through it
(groupnorm.py:32-43: it lost to XLA's own fused norm on the TPU), so neither
does the port: the model's ``GroupNorm32`` stays ``F.group_norm`` in fp32.
This module is the op itself, on the port's NCHW layout (the JAX op takes
NHWC): a hand-written CUDA kernel (csrc/group_norm.cu) and its plain
PyTorch version, which follows the JAX formulas (groupnorm.py:80-109): fp32
sums per (image, group), var = max(E[x^2] - E[x]^2, 0), per channel
a = rsqrt(var + eps) * weight and b = bias - mean * a, y = x * a + b,
optional SiLU, cast back to x's dtype.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises, and it raises under a gradient
(``native.refuse_grad``): the kernel has no backward.  The kernel takes x in
bfloat16 or float32 (the element type a template parameter; the output in
x's dtype, float32 unrounded), as the JAX op's output takes its input's
dtype (groupnorm.py:185).  ``fused_group_norm.launches`` counts the bf16
launches, ``fused_group_norm.launches_f32`` the float32 ones: one kernel a
call, which reads x once (a thread block cluster a group keeps it in shared
memory between the sums and the normalisation) and needs no scratch
memory.
``fused_group_norm_sharded`` runs it on each rank's rows of a batch sharded
over a mesh's dp axis.
"""

from __future__ import annotations

import math

import torch

from gswm_torch import native


def _check_args(x: torch.Tensor, groups: int, act: str | None) -> None:
    if act not in (None, "silu"):
        raise ValueError(f"fused_group_norm: unsupported act {act!r}")
    if x.dim() < 3 or x.shape[1] % groups:
        raise ValueError(f"fused_group_norm: x {tuple(x.shape)} is not (B, C, ...) "
                         f"with C divisible by {groups} groups")


def fused_group_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                               bias: torch.Tensor, groups: int = 32,
                               eps: float = 1e-5, act: str | None = None) -> torch.Tensor:
    """Plain version: GroupNorm over (B, C, ...) ``x`` in fp32, then ``act``."""
    _check_args(x, groups, act)
    b, c = x.shape[:2]
    xf = x.to(torch.float32).reshape(b, groups, -1)
    mean = xf.mean(dim=-1)
    var = torch.clamp(xf.square().mean(dim=-1) - mean.square(), min=0.0)
    inv = torch.rsqrt(var + eps).repeat_interleave(c // groups, dim=1)  # (B, C)
    a = inv * weight.to(torch.float32)
    shift = bias.to(torch.float32) - mean.repeat_interleave(c // groups, dim=1) * a
    bcast = (b, c) + (1,) * (x.dim() - 2)
    y = x.to(torch.float32) * a.reshape(bcast) + shift.reshape(bcast)
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def fused_group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     groups: int = 32, eps: float = 1e-5,
                     act: str | None = None) -> torch.Tensor:
    """GroupNorm (+ optional SiLU) over (B, C, ...) ``x``; weight and bias
    (C,).  CPU: ``fused_group_norm_reference``.  CUDA: the kernel of
    csrc/group_norm.cu (bf16 or float32 x, contiguous and 16-byte aligned;
    any C divisible by ``groups``, any spatial size)."""
    _check_args(x, groups, act)
    if x.device.type == "cpu":
        return fused_group_norm_reference(x, weight, bias, groups, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_group_norm: unsupported device {x.device}")
    native.refuse_grad("fused_group_norm", x, weight, bias)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_group_norm: the CUDA kernel takes torch.bfloat16 or "
                        f"torch.float32, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("fused_group_norm: the CUDA kernel takes contiguous, "
                         "16-byte aligned x")
    b, c = x.shape[:2]
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"fused_group_norm: weight {tuple(weight.shape)} and bias "
                         f"{tuple(bias.shape)} are not ({c},)")
    # fp32 parameters on x's device, as the models keep their norms, pass as
    # they are: nothing is converted or copied
    w, bb = (p if p.dtype == torch.float32 and p.device == x.device and p.is_contiguous()
             else p.to(device=x.device, dtype=torch.float32).contiguous()
             for p in (weight, bias))
    f32 = x.dtype == torch.float32
    out = torch.empty_like(x)
    native.launch(x.device, "gswm_group_norm_f32" if f32 else "gswm_group_norm", x.data_ptr(),
                  w.data_ptr(), bb.data_ptr(), out.data_ptr(), b, c, math.prod(x.shape[2:]),
                  groups, float(eps), 1 if act == "silu" else 0)
    if f32:
        fused_group_norm.launches_f32 += 1
    else:
        fused_group_norm.launches += 1
    return out


fused_group_norm.launches = 0
fused_group_norm.launches_f32 = 0


def fused_group_norm_sharded(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                             mesh=None, **kw) -> torch.Tensor:
    """``fused_group_norm`` partitioned over a mesh's dp axis: the
    counterpart of ``gswm.ops.groupnorm.fused_group_norm_sharded``
    (groupnorm.py:156).  GroupNorm is independent image by image, so each
    rank normalises its rows of the whole ``x`` (the same on every rank) with
    the kernel, and an all_gather over dp returns the whole output on every
    rank.  Falls back to ``fused_group_norm`` on the whole ``x`` where the
    JAX function does (groupnorm.py:165-171): no mesh, no dp axis or dp = 1,
    or a batch dp does not divide."""
    from gswm_torch.sharding import mesh as meshes

    if not meshes.batch_divisible(mesh, x.shape[0]):
        return fused_group_norm(x, weight, bias, **kw)
    y = fused_group_norm(meshes.shard_batch(x, mesh), weight, bias, **kw)
    return meshes.gather_batch(y, mesh)
