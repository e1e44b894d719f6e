"""Fused GroupNorm (+ SiLU): the port's counterpart of the JAX package's
``gswm.ops.groupnorm.fused_group_norm`` Pallas op.

The JAX package exports the op but does not route its model through it
(groupnorm.py:32-43: it lost to XLA's own fused norm on the TPU), so neither
does the port: the model's ``GroupNorm32`` stays ``F.group_norm`` in fp32.
This module is the op itself on (B, C, ...) x in either of two memory
layouts: contiguous NCHW, the port's own, and channels-minor, C the
fastest-moving dimension (``torch.channels_last`` for 4-D x), which is the
JAX op's NHWC memory reached with no copy.  A hand-written CUDA kernel
(csrc/group_norm.cu) and its plain PyTorch version, which follows the JAX
formulas (groupnorm.py:80-109): fp32 sums per (image, group), var =
max(E[x^2] - E[x]^2, 0), per channel a = rsqrt(var + eps) * weight and b =
bias - mean * a, y = x * a + b, optional SiLU, cast back to x's dtype, the
output in x's memory layout.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises, and it raises under a gradient
(``native.refuse_grad``): the kernel has no backward.  The kernel takes x in
bfloat16 or float32 (the element type a template parameter; the output in
x's dtype, float32 unrounded), as the JAX op's output takes its input's
dtype (groupnorm.py:185); ``entry`` names the C entry of a (layout, dtype)
pair and ``layout_of`` tells the layout, raising on any other strides.  One
kernel a call, which reads x once while the data fits on chip and allocates
nothing but its output here: NCHW, a thread block cluster a group keeps it
in shared memory between the sums and the normalisation, or, for float32
groups above 16 x 220 KB, a persistent grid of one block an SM; channels-
minor, the slab kernel, whose unit is a slab of whole groups of one image
(a column of 128 bytes or more of every pixel), kept by a cluster that adds
its sums in distributed shared memory, or by a persistent grid where a
slab outgrows 16 blocks.  The grids' sums and meeting counters are each
launch's own, taken by the C entry from the stream's pool, so calls on
several streams at once share nothing.  Its launches are counted by layout and
dtype: ``fused_group_norm.launches`` (NCHW bf16), ``.launches_f32`` (NCHW
float32), ``.launches_nhwc`` and ``.launches_nhwc_f32``.
``fused_group_norm_sharded`` runs it on each rank's rows of a batch sharded
over a mesh's dp axis, in x's layout.
"""

from __future__ import annotations

import math

import torch

from gswm_torch import native


NCHW, NHWC = "nchw", "nhwc"
# the C entry of each (layout, dtype) pair, and the wrapper's counter of its
# launches
ENTRIES = {(NCHW, torch.bfloat16): ("gswm_group_norm", "launches"),
           (NCHW, torch.float32): ("gswm_group_norm_f32", "launches_f32"),
           (NHWC, torch.bfloat16): ("gswm_group_norm_nhwc", "launches_nhwc"),
           (NHWC, torch.float32): ("gswm_group_norm_nhwc_f32", "launches_nhwc_f32")}
# channels-minor x: the slab kernel's unit is a slab of whole groups, whose
# column of channels a block's 512 threads hold, 16 bytes each where C *
# itemsize % 16 == 0 (csrc/group_norm.cu SLAB_THREADS: a slab of at most 8192
# bytes a pixel), one channel each otherwise (at most 512 channels): any C
# whose groups are no wider
NHWC_MAX_SLAB_BYTES = 8192
NHWC_MAX_ELEMENT_SLAB = 512


def nhwc_slab_fits(c: int, groups: int, itemsize: int) -> bool:
    """Whether the slab kernel takes channels-minor x of ``c`` channels in
    ``groups`` groups: some number of whole groups (a divisor of ``groups``)
    makes a column of 16-byte vectors no wider than ``NHWC_MAX_SLAB_BYTES``
    (C * itemsize % 16 == 0), or of at most ``NHWC_MAX_ELEMENT_SLAB``
    channels (otherwise).  The fewest such groups is the narrowest, so it
    decides (csrc/group_norm.cu pick_slab)."""
    cpg = c // groups
    for gs in (d for d in range(1, groups + 1) if groups % d == 0):
        if c * itemsize % 16:
            return gs * cpg <= NHWC_MAX_ELEMENT_SLAB
        if gs * cpg * itemsize % 16 == 0:
            return gs * cpg * itemsize <= NHWC_MAX_SLAB_BYTES
    return False


def _to_minor(dim: int) -> tuple[int, ...]:
    """The permutation of (B, C, ...) to (B, ..., C); its inverse is
    ``_from_minor``."""
    return (0, *range(2, dim), 1)


def _from_minor(dim: int) -> tuple[int, ...]:
    return (0, dim - 1, *range(1, dim - 1))


def _channels_minor(x: torch.Tensor) -> bool:
    if x.dim() == 4:
        return x.is_contiguous(memory_format=torch.channels_last)
    return x.dim() >= 3 and x.stride(1) == 1 and x.permute(_to_minor(x.dim())).is_contiguous()


def layout_of(x: torch.Tensor) -> str:
    """``NCHW`` for contiguous (B, C, ...) x, ``NHWC`` for channels-minor x
    (``x.stride(1) == 1`` and ``x.permute(0, 2, ..., 1)`` contiguous:
    ``torch.channels_last`` in 4-D); ValueError naming the two for any other
    strides.  Where both hold (C == 1, or one pixel) the memory is the same
    and NCHW is named."""
    if x.is_contiguous():
        return NCHW
    if _channels_minor(x):
        return NHWC
    raise ValueError(f"fused_group_norm: x of strides {tuple(x.stride())} is neither "
                     f"contiguous (NCHW) nor channels-minor (NHWC, torch.channels_last)")


def entry(layout: str, dtype: torch.dtype) -> str:
    """The C entry that runs x of ``dtype`` in ``layout`` (``NCHW`` or
    ``NHWC``): TypeError naming the dtype where no kernel takes it (float16
    and every other dtype), ValueError for another layout."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_group_norm: the CUDA kernel takes torch.bfloat16 or "
                        f"torch.float32, got {dtype}")
    if layout not in (NCHW, NHWC):
        raise ValueError(f"fused_group_norm: layout {layout!r} is neither {NCHW!r} nor "
                         f"{NHWC!r}")
    return ENTRIES[layout, dtype][0]


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
    (C,); the output in x's dtype and memory layout.  CPU:
    ``fused_group_norm_reference``.  CUDA: the kernel of csrc/group_norm.cu
    (bf16 or float32 x, contiguous NCHW or channels-minor, 16-byte aligned;
    any C divisible by ``groups``, any spatial size; channels-minor x where
    ``nhwc_slab_fits``: groups of at most 4096 bf16 or 2048 float32
    channels, or 512 where C * itemsize % 16 != 0)."""
    _check_args(x, groups, act)
    if x.device.type == "cpu":
        return fused_group_norm_reference(x, weight, bias, groups, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"fused_group_norm: unsupported device {x.device}")
    native.refuse_grad("fused_group_norm", x, weight, bias)
    layout = layout_of(x)
    name = entry(layout, x.dtype)
    if x.data_ptr() % 16:
        raise ValueError("fused_group_norm: the CUDA kernel takes 16-byte aligned x")
    b, c = x.shape[:2]
    if layout == NHWC and not nhwc_slab_fits(c, groups, x.element_size()):
        raise ValueError(f"fused_group_norm: channels-minor x of {c} channels in {groups} "
                         f"groups has groups wider than the slab kernel takes (a slab of "
                         f"{NHWC_MAX_SLAB_BYTES} bytes a pixel, or {NHWC_MAX_ELEMENT_SLAB} "
                         f"channels where C * itemsize % 16 != 0)")
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"fused_group_norm: weight {tuple(weight.shape)} and bias "
                         f"{tuple(bias.shape)} are not ({c},)")
    # fp32 parameters on x's device, as the models keep their norms, pass as
    # they are: nothing is converted or copied
    w, bb = (p if p.dtype == torch.float32 and p.device == x.device and p.is_contiguous()
             else p.to(device=x.device, dtype=torch.float32).contiguous()
             for p in (weight, bias))
    out = torch.empty_like(x)  # x's strides: NCHW or channels-minor
    native.launch(x.device, name, x.data_ptr(), w.data_ptr(), bb.data_ptr(), out.data_ptr(),
                  b, c, math.prod(x.shape[2:]), groups, float(eps), 1 if act == "silu" else 0)
    counter = ENTRIES[layout, x.dtype][1]
    setattr(fused_group_norm, counter, getattr(fused_group_norm, counter) + 1)
    return out


for _, _counter in ENTRIES.values():
    setattr(fused_group_norm, _counter, 0)


def fused_group_norm_sharded(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                             mesh=None, **kw) -> torch.Tensor:
    """``fused_group_norm`` partitioned over a mesh's dp axis: the
    counterpart of ``gswm.ops.groupnorm.fused_group_norm_sharded``
    (groupnorm.py:156).  GroupNorm is independent image by image, so each
    rank normalises its rows of the whole ``x`` (the same on every rank) with
    the kernel, and an all_gather over dp returns the whole output on every
    rank.  Falls back to ``fused_group_norm`` on the whole ``x`` where the
    JAX function does (groupnorm.py:165-171): no mesh, no dp axis or dp = 1,
    or a batch dp does not divide.  Channels-minor x stays channels-minor:
    each rank's rows and the gathered output keep x's memory layout."""
    from gswm_torch.sharding import mesh as meshes

    if not meshes.batch_divisible(mesh, x.shape[0]):
        return fused_group_norm(x, weight, bias, **kw)
    if x.is_contiguous() or not _channels_minor(x):
        y = fused_group_norm(meshes.shard_batch(x, mesh), weight, bias, **kw)
        return meshes.gather_batch(y, mesh)
    # channels-minor: shard and gather the contiguous (B, ..., C) view, so
    # neither step copies x into NCHW
    to, back = _to_minor(x.dim()), _from_minor(x.dim())
    y = fused_group_norm(meshes.shard_batch(x.permute(to), mesh).permute(back), weight, bias,
                         **kw)
    return meshes.gather_batch(y.permute(to), mesh).permute(back)
