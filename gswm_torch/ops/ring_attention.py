"""Ring attention: sequence-parallel attention over a mesh's sp axis.

The counterpart of ``gswm.ops.ring_attention`` (the long-context extension
for latents that outgrow one card: SDXL's 16,384 tokens and beyond).  Each
rank keeps its query shard; per ring step it attends it against the visiting
k/v shard and passes that shard to its right neighbour, so after sp steps
every query shard has seen every key.

The JAX package runs each step's attention as plain XLA (an einsum with the
online-softmax recurrence, ``_ring_attend_local``); the port runs it through
the split flash kernel with its log-sum-exp output (``flash_attention_split``
with ``return_lse``: in bf16 csrc/flash_hopper.cu at d <= 64,
csrc/flash_mid.cu to 160, csrc/flash_split.cu above; in float32
csrc/flash_f32.cu's kernel at every d, ``gswm_flash_f32_lse``) and folds
each step's normalised partial into a running fp32 ``(out, lse)``:

    lse' = logaddexp(lse, lse_i)
    out' = out * exp(lse - lse') + out_i * exp(lse_i - lse')

which is the same exact softmax as the reference's running-max recurrence
(no clamp), merged a shard at a time instead of a key chunk at a time.  The
partials are folded in fp32 and cast to the input dtype once, at the end.
k and v rotate by ``torch.distributed.batch_isend_irecv`` over the sp group.

The JAX function leaves its output sequence-sharded; this one, like every
sharded function of the port, takes the whole tensors on every rank and
returns the whole output on every rank (an all_gather over sp, and over dp
where the batch was sharded).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from gswm_torch.ops.attention import flash_attention_split
from gswm_torch.sharding import mesh as meshes


def ring_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              acc: Optional[tuple] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One ring step on one rank: (B, Sq, H, D) q against the visiting
    (B, Sk, H, D) k/v shard, folded into ``acc`` = (out fp32 (B, Sq, H, D),
    lse fp32 (B, H, Sq)) from the steps before (None on the first).  Returns
    the new ``acc``."""
    out_i, lse_i = flash_attention_split(q, k, v, return_lse=True)
    out_i = out_i.to(torch.float32)
    if acc is None:
        return out_i, lse_i
    out, lse = acc
    new = torch.logaddexp(lse, lse_i)

    def weight(x):  # (B, H, Sq) -> (B, Sq, H, 1)
        return torch.exp(x - new).transpose(1, 2).unsqueeze(-1)

    return out * weight(lse) + out_i * weight(lse_i), new


def ring_finish(acc: tuple, dtype: torch.dtype) -> torch.Tensor:
    """The folded output of the last ring step, cast to ``dtype``."""
    return acc[0].to(dtype)


def _rotate(k: torch.Tensor, v: torch.Tensor, group, right: int, left: int) -> tuple:
    """Send k and v to global rank ``right``, receive the left neighbour's."""
    k_in, v_in = torch.empty_like(k), torch.empty_like(v)
    ops = [dist.P2POp(dist.isend, k, right, group, 0), dist.P2POp(dist.irecv, k_in, left, group, 0),
           dist.P2POp(dist.isend, v, right, group, 1), dist.P2POp(dist.irecv, v_in, left, group, 1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return k_in, v_in


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh=None,
                   axis: str = "sp") -> torch.Tensor:
    """(B, S, H, D) q/k/v, the whole tensors on every rank -> (B, S, H, D) on
    every rank, with S sharded over mesh axis ``axis`` while it is computed.

    Falls back to ``flash_attention_split`` on the whole tensors where the
    JAX function does (ring_attention.py:105-114): no mesh, the axis absent
    or of size 1, or a sequence the axis does not divide.  The batch is
    sharded over dp too where the mesh has a dp axis that divides it
    (ring_attention.py:116-118).  ``ring_attention.calls`` counts the calls
    that took the ring."""
    sp = meshes.axis_size(mesh, axis)
    if sp == 1 or q.shape[1] % sp or k.shape[1] % sp:
        return flash_attention_split(q, k, v)
    ring_attention.calls += 1
    by_dp = meshes.batch_divisible(mesh, q.shape[0])
    if by_dp:
        q, k, v = (meshes.shard_batch(t, mesh) for t in (q, k, v))
    q, k, v = (meshes.shard_dim(t, mesh, axis, 1) for t in (q, k, v))
    group = mesh.get_group(axis)
    r = mesh.get_local_rank(axis)
    right = dist.get_global_rank(group, (r + 1) % sp)
    left = dist.get_global_rank(group, (r - 1) % sp)
    acc = None
    for step in range(sp):
        acc = ring_step(q, k, v, acc)
        if step + 1 < sp:
            k, v = _rotate(k, v, group, right, left)
    out = meshes.gather_dim(ring_finish(acc, q.dtype), mesh, axis, 1)
    return meshes.gather_batch(out, mesh) if by_dp else out


ring_attention.calls = 0
