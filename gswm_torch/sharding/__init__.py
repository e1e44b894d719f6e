"""Device-mesh parallelism of the PyTorch port: the counterpart of
``gswm.sharding``.

The JAX package names a ``jax.sharding.Mesh`` and lets GSPMD insert the
collectives; the port names a ``torch.distributed.device_mesh.DeviceMesh``
with the same axes and runs the collectives itself:

  dp — data parallel over the image batch: each rank runs the pipeline on
       its slice (``shard_batch``) and ``gather_batch`` reassembles it;
  tp — tensor parallel over the UNet's attention heads and MLP width:
       ``shard_params`` slices the Megatron layers in place and records the
       group their row-parallel outputs are summed over;
  sp — sequence parallel (``ops.ring_attention``), present when sp > 1.

The process group is the caller's: gloo for the CPU, NCCL for CUDA, asked
for by name (``init_process_group``, ``launch.spawn``), never chosen here.
"""

from gswm_torch.sharding.mesh import (  # noqa: F401
    axis_size,
    batch_sharding,
    gather_batch,
    init_process_group,
    make_mesh,
    replicate,
    shard_batch,
    shard_params,
    unet_param_specs,
)
