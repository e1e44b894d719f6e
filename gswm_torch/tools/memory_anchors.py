"""Measure the extraction chain's peak device memory against the batch: the
anchors of ``gswm_torch.utils.memory``.

    python -m gswm_torch.tools.memory_anchors [--sweep PRESET:RES:B1,B2,B3 ...]
        [--steps 2] [--check-steps 30] [--suggested] [--out FILE.jsonl]

On one card, random weights from a seed, bf16: for each sweep (default:
sd-2-1-base at 512 at batches 32, 64, 128; sd-2-1 at 768 at 16, 32, 64;
sdxl-base at 1024 at 8, 16, 32: at or above the VAE's chunk) the pipeline is
built, the chain runs once at the smallest batch to warm up, then
``memory.chain_peaks`` at each batch
(embed, VAE encode, ``--steps``-step inversion, decode: each stage's peak and
the chain's, GiB); then the chain's peak at the smallest batch with
``--check-steps`` steps beside the ``--steps`` one, the least-squares line
(fixed GiB, GiB an image) through each stage's peaks, and each batch's peak
beside the larger line's.  The lines are what ``memory.ANCHORS_H100``
holds.  ``--suggested``: then the chain at ``memory.suggest_batch`` for this
card, its peak and images/s.  Run with
``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`` (the tool sets it
unless the environment does): the default allocator fragments at the
suggested batches.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch

DEFAULT_SWEEPS = ("sd-2-1-base:512:32,64,128", "sd-2-1:768:16,32,64",
                  "sdxl-base:1024:8,16,32")


def run_suggested(pipe, preset: str, res: int, arch: str, steps: int) -> dict:
    """The chain at ``memory.suggest_batch`` for this card: its peak beside
    the model's and the card's memory, and its images/s."""
    from gswm_torch.tools import paths
    from gswm_torch.utils import memory

    b = memory.suggest_batch(res, arch=arch)
    peaks = memory.chain_peaks(pipe, paths.config(res, "gswm_torch memory"), b, steps)
    total = memory.card_gib()
    print(f"{preset} {res}: suggested batch {b}: peak {peaks['chain']:.4f} GiB "
          f"({peaks['chain'] / total:.2%} of {total:.4f}), model "
          f"{memory.predicted_peak_gib(res, b, arch):.4f}, reserved {peaks['reserved']:.4f}; "
          f"{peaks['images_per_s']:.4f} images/s at {steps} steps", flush=True)
    return {"batch": b, **peaks}


def sweep(preset: str, res: int, batches, steps: int, check_steps: int,
          suggested: bool = False) -> dict:
    from gswm_torch.tools import paths
    from gswm_torch.utils import memory

    pipe = paths.build_pipeline(preset)
    cfg = paths.config(res, "gswm_torch memory")
    memory.chain_peaks(pipe, cfg, min(batches), steps)  # warm-up
    rows = []
    for b in batches:
        peaks = memory.chain_peaks(pipe, cfg, b, steps, seed=b)
        rows.append({"preset": preset, "res": res, "batch": b, "steps": steps, **peaks})
        print(json.dumps(rows[-1]), flush=True)
    long = memory.chain_peaks(pipe, cfg, min(batches), check_steps, seed=1)
    short = next(r for r in rows if r["batch"] == min(batches))
    print(f"{preset} {res}: chain peak at batch {min(batches)}: {short['chain']:.4f} GiB "
          f"at {steps} steps, {long['chain']:.4f} at {check_steps} "
          f"({long['chain'] / short['chain'] - 1:+.4%})", flush=True)
    fits = {stage: memory.fit_anchor(list(batches), [r[stage] for r in rows])
            for stage in memory.STAGES}
    for r in rows:
        r["line"] = max(fixed + per * r["batch"] for fixed, per in fits.values())
        print(f"  batch {r['batch']}: measured {r['chain']:.4f} GiB, lines {r['line']:.4f} "
              f"({r['line'] / r['chain'] - 1:+.4%})", flush=True)
    print(f"{preset} {res}: anchor {res}: "
          + "{" + ", ".join(f'"{k}": ({v[0]:.4f}, {v[1]:.6f})' for k, v in fits.items())
          + "}", flush=True)
    arch = "sdxl" if pipe.preset.text2 is not None else "sd"
    at_suggested = run_suggested(pipe, preset, res, arch, steps) if suggested else None
    del pipe
    torch.cuda.empty_cache()
    return {"preset": preset, "res": res, "rows": rows, "fits": fits,
            "check_steps": {"steps": check_steps, "chain": long["chain"]},
            "suggested": at_suggested}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", nargs="+", default=list(DEFAULT_SWEEPS),
                    help="PRESET:RES:B1,B2,... (default: %(default)s)")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--check-steps", type=int, default=30)
    ap.add_argument("--out", default=None, help="jsonl of every sweep")
    ap.add_argument("--suggested", action="store_true",
                    help="then run the chain at memory.suggest_batch for this card")
    args = ap.parse_args(argv)
    # the lines are of allocated bytes; the default caching allocator
    # fragments at the batches the policy suggests (utils/memory.py)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    if torch.cuda.device_count() < 1:
        raise SystemExit("memory_anchors: no CUDA device; the anchors are the card's")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    print(f"total memory {torch.cuda.get_device_properties(0).total_memory / 2**30:.4f} "
          "GiB", flush=True)
    results = []
    for spec in args.sweep:
        preset, res, batches = spec.split(":")
        results.append(sweep(preset, int(res), [int(b) for b in batches.split(",")],
                             args.steps, args.check_steps, args.suggested))
    if args.out:
        with open(args.out, "w") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
