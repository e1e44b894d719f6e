"""Per-user keys at registry scale as one recorded run: the counterpart of
``tools/run_config5_artifact.py``, its three phases and records.

    python -m gswm_torch.tools.run_config5_artifact [--n 10000] [--device cuda]
    torchrun --nproc-per-node=4 -m gswm_torch.tools.run_config5_artifact
    python -m gswm_torch.tools.run_config5_artifact --spawn 2 --device cpu --n 64

  phase 1  embed   n latents of 512x512 (4 x 64 x 64), each under its own
                   key, nonce and 256-bit message, 1000 a call (every rank
                   the same, from seeds);
  phase 2  decode  all n latents under their own keys, batch-sharded over
                   the world's ranks (``sharding.shard_batch`` on a dp mesh,
                   ``gather_batch`` back): every decode must be exact;
  phase 3  trace   16 probe latents attributed against the whole registry
                   by the host loop on the native host library
                   (``eval.trace.find_source`` on ``hostlib``), and one by
                   ``find_source_device``.

Rank 0 writes one record a phase, with rates and accuracies, to ``--out``
(default ``build/config5_multikey_trace_torch.jsonl`` at the root of the
checkout) and prints each.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import time
from pathlib import Path

import numpy as np
import torch

from gswm_torch.config import GSConfig
from gswm_torch.core import bits as bitops
from gswm_torch.core.multikey import embed_latents_multikey, recover_message_bits_multikey
from gswm_torch.eval import trace
from gswm_torch.sharding import gather_batch, make_mesh, shard_batch
from gswm_torch.sharding.launch import run_world

OUT = str(Path(__file__).resolve().parents[2] / "build" / "config5_multikey_trace_torch.jsonl")
CHUNK = 1000
PROBES = 16


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(n_total: int, device: str, out_path: str) -> list:
    """The three phases on this rank of the joined process group; the
    records (rank 0's are written)."""
    import torch.distributed as dist

    dev = torch.device(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    rng = random.Random(0)
    registry = [{"key_hex": rng.randbytes(32).hex(), "nonce_hex": rng.randbytes(16).hex(),
                 "message_hex": rng.randbytes(32).hex(), "message_length": 256}
                for _ in range(n_total)]
    keys = [bytes.fromhex(r["key_hex"]) for r in registry]
    nonces = [bytes.fromhex(r["nonce_hex"]) for r in registry]
    cfg = GSConfig(key_hex="00" * 32, nonce_hex="00" * 16, message="",
                   width=512, height=512, message_bits=256)
    records = []

    def record(rec: dict) -> None:
        records.append(rec)
        if rank == 0:
            print(rec, flush=True)

    # phase 1: embed, chunk by chunk
    _sync(dev)
    t0 = time.perf_counter()
    latents = torch.cat([embed_latents_multikey(
        cfg, keys[c0:c0 + CHUNK], nonces[c0:c0 + CHUNK],
        [bytes.fromhex(r["message_hex"]) for r in registry[c0:c0 + CHUNK]],
        generator=torch.Generator(device=dev).manual_seed(c0), device=dev)[0]
        for c0 in range(0, n_total, CHUNK)])
    _sync(dev)
    dt = time.perf_counter() - t0
    record({"phase": "embed_multikey", "images": n_total, "seconds": dt,
            "imgs_per_sec": n_total / dt, "device": str(dev)})

    # phase 2: decode, the batch sharded over the world's ranks
    mesh = make_mesh(dp=world, tp=1, device_type=dev.type)
    want = torch.from_numpy(np.stack([bitops.hex_to_bits(r["message_hex"])[:256]
                                      for r in registry])).to(dev)
    _sync(dev)
    t0 = time.perf_counter()
    exact = 0
    for c0 in range(0, n_total, CHUNK):
        c1 = min(c0 + CHUNK, n_total)
        n = (c1 - c0) // world
        lo = c0 + rank * n
        voted = gather_batch(recover_message_bits_multikey(
            shard_batch(latents[c0:c1], mesh), cfg, keys[lo:lo + n], nonces[lo:lo + n]), mesh)
        exact += int((voted == want[c0:c1]).all(dim=1).sum())
    _sync(dev)
    dt = time.perf_counter() - t0
    record({"phase": "decode_dp_sharded", "images": n_total, "mesh_ranks": world,
            "backend": dist.get_backend(), "seconds": dt, "imgs_per_sec": n_total / dt,
            "exact_decodes": exact, "decode_accuracy": exact / n_total})

    # phase 3: attribution against the whole registry, on rank 0
    probes = [rng.randrange(n_total) for _ in range(PROBES)]
    hits = PROBES
    if rank == 0:
        host = latents[probes].cpu().numpy()
        t0 = time.perf_counter()
        hits = 0
        for j, i in enumerate(probes):
            best, acc, _ = trace.find_source(host[j], registry)
            hits += int(best == i and acc == 1.0)
        dt = time.perf_counter() - t0
        record({"phase": "trace_native", "probes": PROBES, "registry_size": n_total,
                "seconds": dt, "candidates_per_sec": PROBES * n_total / dt,
                "correct_attributions": hits})
        _sync(dev)
        t0 = time.perf_counter()
        best, acc, _ = trace.find_source_device(latents[probes[0]], registry, device=dev)
        _sync(dev)
        record({"phase": "trace_device", "probes": 1, "registry_size": n_total,
                "seconds": time.perf_counter() - t0,
                "correct": bool(best == probes[0] and acc == 1.0)})
        if not records[-1]["correct"]:
            raise AssertionError("find_source_device missed its probe")
    if exact != n_total:
        raise AssertionError(f"DP decode exact for {exact} of {n_total} images")
    if hits != PROBES:
        raise AssertionError(f"{hits} of {PROBES} probes attributed to their record")
    if rank == 0:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
        print(f"wrote {out_path}", flush=True)
    return records


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=10000, help="registry size")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--spawn", type=int, default=0,
                    help="start this many ranks (gloo on the CPU, NCCL on CUDA)")
    ap.add_argument("--out", default=OUT)
    return ap


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    return run_world(run, (args.n, args.device, args.out), torch.device(args.device).type,
                     args.spawn)


if __name__ == "__main__":
    main()
