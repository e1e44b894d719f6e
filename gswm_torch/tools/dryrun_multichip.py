"""The multi-device dry run of the PyTorch port: the counterpart of
``__graft_entry__.py:dryrun_multichip`` (:130-268), its four legs on every
rank of one process group.

    torchrun --nproc-per-node=4 -m gswm_torch.tools.dryrun_multichip
    python -m gswm_torch.tools.dryrun_multichip --spawn 4 --device cpu

With ``--spawn N`` it starts N gloo (CPU) or NCCL (CUDA) ranks itself; under
``torchrun`` it joins the launcher's group; alone, a group of one.  On the
tiny preset, float32, random weights from seed 0:

  1. dp x tp (tp = 2 where the world is even): the UNet tensor-parallel
     (``sharding.shard_params``), each dp rank a slice of the batch: embed
     -> 4-step generation -> 4-step inversion -> decode, bit accuracy > 0.97;
  2. DP alone (dp = world): the same round trip's voted bits equal the
     single-process run's, bit for bit (per-image work is independent);
  3. sp = 2 (even worlds): ``ring_attention`` on (2, 64 sp, 2, 32) against
     the plain version, max error < 1e-4;
  4. dp x sp: one UNet forward at t = 500 whose level-0 self-attention (64
     tokens, ``GSWM_FLASH_MIN_SEQ=64`` for the leg, then restored) takes the
     ring, against the single-process forward, max error < 1e-3.

An odd world skips legs 3 and 4, as the reference does.  Rank 0 prints one
line; every rank returns the legs' numbers.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from gswm_torch.config import GSConfig
from gswm_torch.core import bits as bitops
from gswm_torch.core.decode import recover_message_bits
from gswm_torch.core.embed import embed_latents
from gswm_torch.ops.attention import flash_attention_split_reference
from gswm_torch.ops.ring_attention import ring_attention
from gswm_torch.pipelines import InversablePipeline
from gswm_torch.sharding import gather_batch, make_mesh, shard_batch, shard_params
from gswm_torch.sharding.launch import run_world

STEPS = 4
MIN_ROUNDTRIP = 0.97
RING_BOUND = 1e-4
UNET_SP_BOUND = 1e-3


def _pipeline(device) -> InversablePipeline:
    return InversablePipeline("tiny", device=device, dtype=torch.float32,
                              generator=torch.Generator(device=device).manual_seed(0))


def _roundtrip(pipe, z_t, mesh=None):
    """Generation then inversion at STEPS steps; each rank its dp rows when a
    mesh is given, the whole batch back on every rank."""
    x = shard_batch(z_t, mesh) if mesh is not None else z_t
    x0 = pipe.generate(x, guidance_scale=1.0, num_steps=STEPS, decode=False)
    z = pipe.invert(latents=x0, num_steps=STEPS)
    return gather_batch(z, mesh) if mesh is not None else z


def dryrun(device: str = "cuda") -> dict:
    """The four legs on this rank of the joined process group."""
    import torch.distributed as dist

    dev = torch.device(device)
    world = dist.get_world_size()
    cfg = GSConfig(key_hex="22" * 32, nonce_hex="33" * 16, message="dryrun",
                   width=64, height=64, message_bits=32)
    # divisible by dp in the dp x tp mesh and by the world in the DP leg
    batch = max(world, 2)
    z_t, msg = embed_latents(cfg, generator=torch.Generator(device=dev).manual_seed(1),
                             batch=batch, device=dev)
    want = torch.from_numpy(bitops.bytes_to_bits(msg)).to(dev)

    tp = 2 if world % 2 == 0 else 1
    mesh = make_mesh(tp=tp, device_type=dev.type)
    pipe = _pipeline(dev)
    shard_params(pipe.unet, mesh)
    voted = recover_message_bits(_roundtrip(pipe, z_t, mesh), cfg)
    acc = (voted == want).float().mean().item()
    if acc <= MIN_ROUNDTRIP:
        raise AssertionError(f"dp x tp watermark round trip accuracy {acc}")

    dp_mesh = make_mesh(dp=world, tp=1, device_type=dev.type)
    pipe = _pipeline(dev)
    z_dp = _roundtrip(pipe, z_t, dp_mesh)
    z_one = _roundtrip(pipe, z_t)
    n_diff = int((recover_message_bits(z_dp, cfg) != recover_message_bits(z_one, cfg)).sum())
    if n_diff:
        raise AssertionError(f"DP vs single-process decode differs in {n_diff} bits")
    out = dict(world=world, dp=world // tp, tp=tp, batch=batch, accuracy=acc, dp_bits_differ=0,
               dp_max_abs_z=(z_dp - z_one).abs().max().item())

    if world % 2 == 0:
        sp = 2
        sp_mesh = make_mesh(dp=world // sp, tp=1, sp=sp, device_type=dev.type)
        rng = np.random.default_rng(7)
        q, k, v = (torch.from_numpy(rng.standard_normal((2, 64 * sp, 2, 32), np.float32)).to(dev)
                   for _ in range(3))
        ring_err = (ring_attention(q, k, v, sp_mesh)
                    - flash_attention_split_reference(q, k, v)).abs().max().item()
        if ring_err >= RING_BOUND:
            raise AssertionError(f"ring attention mismatch {ring_err}")

        saved = os.environ.get("GSWM_FLASH_MIN_SEQ")
        os.environ["GSWM_FLASH_MIN_SEQ"] = "64"  # the tiny level 0's 64 tokens
        try:
            pipe = _pipeline(dev)
            ctx = pipe.empty_context(batch)
            t = torch.full((batch,), 500, dtype=torch.int32, device=dev)
            with torch.inference_mode():
                want_u = pipe.unet(z_t, t, ctx)
                shard_params(pipe.unet, sp_mesh)
                calls = ring_attention.calls
                got_u = gather_batch(pipe.unet(shard_batch(z_t, sp_mesh), shard_batch(t, sp_mesh),
                                               shard_batch(ctx, sp_mesh)), sp_mesh)
            ring_calls = ring_attention.calls - calls
        finally:
            if saved is None:
                os.environ.pop("GSWM_FLASH_MIN_SEQ", None)
            else:
                os.environ["GSWM_FLASH_MIN_SEQ"] = saved
        unet_err = (got_u - want_u).abs().max().item()
        if not ring_calls or unet_err >= UNET_SP_BOUND:
            raise AssertionError(f"UNet forward under sp: {ring_calls} ring calls, "
                                 f"max error {unet_err}")
        out.update(sp=sp, ring_err=ring_err, unet_sp_err=unet_err, unet_ring_calls=ring_calls)
        note = (f"; ring sp={sp} max err {ring_err:.2e}; UNet-under-sp max err {unet_err:.2e} "
                f"({ring_calls} ring calls)")
    else:
        note = "; ring legs skipped (odd world size)"
    if dist.get_rank() == 0:
        print(f"dryrun_multichip ok: {world} ranks ({dist.get_backend()}, {device}), mesh "
              f"dp={world // tp} tp={tp}, batch={batch}, bit accuracy {acc}; DP decode "
              f"bit-identical to one process (max |dz_T| {out['dp_max_abs_z']:.2e}){note}",
              flush=True)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--spawn", type=int, default=0,
                    help="start this many ranks (gloo on the CPU, NCCL on CUDA)")
    return ap


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    return run_world(dryrun, (args.device,), torch.device(args.device).type, args.spawn)


if __name__ == "__main__":
    main()
