"""What the PyTorch port's multi-rank tests run on every rank, through
``gswm_torch.sharding.launch.spawn`` (gloo on the CPU).  A spawned rank
unpickles these functions by importing this module, so it imports neither
jax nor the JAX package: the comparisons with ``gswm`` run in the test
process, on the numpy arrays each rank returns."""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from gswm_torch import GSConfig, embed_latents, recover_message_bits
from gswm_torch.core import bits as bitops
from gswm_torch.models.configs import PRESETS
from gswm_torch.models.layers import Attention, FeedForward
from gswm_torch.models.unet import UNet2DCondition
from gswm_torch.ops.attention import flash_attention_sharded, flash_attention_split
from gswm_torch.ops.groupnorm import fused_group_norm, fused_group_norm_sharded
from gswm_torch.ops.ring_attention import ring_attention
from gswm_torch.pipelines import InversablePipeline
from gswm_torch.sharding import (batch_sharding, gather_batch, make_mesh, replicate,
                                 shard_batch, shard_params, unet_param_specs)

CFG = dict(key_hex="22" * 32, nonce_hex="33" * 16, message="mesh", width=64, height=64,
           message_bits=32)


def _mesh_shape(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _tiny_unet(state: dict) -> UNet2DCondition:
    unet = UNet2DCondition(PRESETS["tiny"].unet).eval().requires_grad_(False)
    unet.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return unet


def _roundtrip(pipe, z_t, steps: int, mesh=None):
    x = shard_batch(z_t, mesh) if mesh is not None else z_t
    x0 = pipe.generate(x, guidance_scale=1.0, num_steps=steps, decode=False)
    z = pipe.invert(latents=x0, num_steps=steps)
    return gather_batch(z, mesh) if mesh is not None else z


def gn_channels_last_inputs():
    """An NHWC array and its scale and bias from a numpy seed, for the
    sharded GroupNorm on channels-last x (the test hands the same array to
    the JAX op)."""
    rng = np.random.default_rng(31)
    x = (rng.standard_normal((4, 6, 5, 64)) * 1.5 + 0.2).astype(np.float32)
    return (x, (1 + 0.1 * rng.standard_normal(64)).astype(np.float32),
            (0.1 * rng.standard_normal(64)).astype(np.float32))


def sharding_world2(state: dict, lat, t, ctx) -> dict:
    """Mesh shapes, the tp = 2 tiny UNet on the JAX package's weights
    (``state``: bridged), the sharded ops against their single-device calls
    and the DP round trip against one process."""
    out = {}
    mesh = make_mesh(device_type="cpu")
    tp_mesh = make_mesh(tp=2, device_type="cpu")
    out["mesh"] = _mesh_shape(mesh)
    out["mesh_tp"] = _mesh_shape(tp_mesh)
    out["mesh_sp_names"] = make_mesh(dp=1, tp=1, sp=2, device_type="cpu").mesh_dim_names
    try:
        make_mesh(tp=3, device_type="cpu")
    except ValueError as e:
        out["mismatch"] = str(e)
    out["batch_sharding"] = [repr(p) for p in batch_sharding(mesh)]
    torch.manual_seed(dist.get_rank())
    lin = torch.nn.Linear(4, 3)
    out["own_weight"] = lin.weight.detach().clone().numpy()
    out["replicated_weight"] = replicate(lin).weight.detach().numpy()

    unet = _tiny_unet(state)
    out["specs"] = {k: repr(p) for k, p in unet_param_specs(unet).items()}
    shard_params(unet, tp_mesh)
    out["slices"] = {k: v.numpy().copy() for k, v in unet.state_dict().items()}
    out["tp_layers"] = sum(m.tp_group is not None for m in unet.modules()
                           if isinstance(m, (Attention, FeedForward)))
    with torch.no_grad():
        out["unet_tp"] = unet(torch.from_numpy(lat), torch.from_numpy(t),
                              torch.from_numpy(ctx)).numpy()

    g = torch.Generator().manual_seed(3)
    x = torch.randn((4, 64, 8, 8), generator=g)
    w, b = 1 + 0.1 * torch.randn(64, generator=g), 0.1 * torch.randn(64, generator=g)
    out["gn_equal"] = torch.equal(
        fused_group_norm_sharded(x, w, b, mesh, groups=32, act="silu"),
        fused_group_norm(x, w, b, 32, act="silu"))
    out["gn_odd_batch_equal"] = torch.equal(
        fused_group_norm_sharded(x[:3], w, b, mesh, groups=32),
        fused_group_norm(x[:3], w, b, 32))
    xn, wn, bn = gn_channels_last_inputs()
    xl = torch.from_numpy(xn).permute(0, 3, 1, 2)  # the NHWC array, channels-last
    y = fused_group_norm_sharded(xl, torch.from_numpy(wn), torch.from_numpy(bn), mesh,
                                 groups=32, act="silu")
    out["gn_channels_last"] = dict(
        nhwc=y.permute(0, 2, 3, 1).numpy().copy(),
        channels_last=y.is_contiguous(memory_format=torch.channels_last),
        equal=torch.equal(y, fused_group_norm(xl, torch.from_numpy(wn), torch.from_numpy(bn),
                                              32, act="silu")))
    for heads, key in ((4, "flash_tp"), (3, "flash_tp_odd_heads")):
        q, k, v = (torch.randn((2, 600, heads, 16), generator=g) for _ in range(3))
        got = flash_attention_sharded(q, k, v, tp_mesh)
        out[key] = (torch.equal(got, flash_attention_split(q, k, v)),
                    (got - flash_attention_split(q, k, v)).abs().max().item())

    pipe = InversablePipeline("tiny", device="cpu", dtype=torch.float32,
                              generator=torch.Generator().manual_seed(0))
    cfg = GSConfig(**CFG)
    z_t, _ = embed_latents(cfg, generator=torch.Generator().manual_seed(1), batch=4,
                           device="cpu")
    z_dp = _roundtrip(pipe, z_t, 2, mesh)
    z_one = _roundtrip(pipe, z_t, 2)
    out["dp_bits_equal"] = torch.equal(recover_message_bits(z_dp, cfg),
                                       recover_message_bits(z_one, cfg))
    out["dp_max_dz"] = (z_dp - z_one).abs().max().item()
    return out


def sharding_world4() -> dict:
    """dp x tp = 2 x 2: embed -> 2-step generation -> 2-step inversion ->
    decode, the UNet tensor-parallel, each dp rank two of four images."""
    mesh = make_mesh(tp=2, device_type="cpu")
    pipe = InversablePipeline("tiny", device="cpu", dtype=torch.float32,
                              generator=torch.Generator().manual_seed(0))
    shard_params(pipe.unet, mesh)
    cfg = GSConfig(**CFG)
    z_t, msg = embed_latents(cfg, generator=torch.Generator().manual_seed(1), batch=4,
                             device="cpu")
    voted = recover_message_bits(_roundtrip(pipe, z_t, 2, mesh), cfg)
    want = torch.from_numpy(bitops.bytes_to_bits(msg))
    return {"mesh": _mesh_shape(mesh), "accuracy": (voted == want).float().mean().item(),
            "tp_layers": sum(m.tp_group is not None for m in pipe.unet.modules()
                             if isinstance(m, (Attention, FeedForward)))}


def ring(cases: list) -> dict:
    """``ring_attention`` on each case (name, mesh dims, q, k, v as arrays):
    its output as numpy and the ring calls it made; plus the tiny UNet's
    forward under an sp mesh (level 0's 64 tokens take the ring at
    GSWM_FLASH_MIN_SEQ=64) against the single-device forward."""
    out = {}
    for name, dims, q, k, v in cases:
        mesh = make_mesh(**dims, device_type="cpu") if dims is not None else None
        calls = ring_attention.calls
        got = ring_attention(*(torch.as_tensor(a) for a in (q, k, v)), mesh)
        out[name] = (got.float().numpy(), ring_attention.calls - calls)

    world = dist.get_world_size()
    sp_mesh = make_mesh(dp=world // 2, tp=1, sp=2, device_type="cpu")
    pipe = InversablePipeline("tiny", device="cpu", dtype=torch.float32,
                              generator=torch.Generator().manual_seed(0))
    batch = 2 * (world // 2)
    z = torch.randn((batch, 4, 8, 8), generator=torch.Generator().manual_seed(5))
    t = torch.full((batch,), 500, dtype=torch.int32)
    ctx = pipe.empty_context(batch)
    os.environ["GSWM_FLASH_MIN_SEQ"] = "64"
    try:
        with torch.no_grad():
            want = pipe.unet(z, t, ctx)
            shard_params(pipe.unet, sp_mesh)
            calls = ring_attention.calls
            got = gather_batch(pipe.unet(shard_batch(z, sp_mesh), shard_batch(t, sp_mesh),
                                         shard_batch(ctx, sp_mesh)), sp_mesh)
    finally:
        del os.environ["GSWM_FLASH_MIN_SEQ"]
    out["unet_sp"] = ((got - want).abs().max().item(), ring_attention.calls - calls)
    return out


def ring_loading(q, k, v, packages: tuple) -> dict:
    """One sp = 2 ring, and which of ``packages`` this rank has loaded, for
    the test that runs the port where jax is unimportable."""
    import sys

    got = ring_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                         make_mesh(dp=1, tp=1, sp=2, device_type="cpu"))
    return {"ring": got.numpy(), "calls": ring_attention.calls,
            "loaded": sorted(m for m in sys.modules if m.split(".")[0] in packages)}
