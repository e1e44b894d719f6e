"""The readings that the limits of ``limits/<cell>.json`` are set from, on
the card at the cell's own size, in one process.

    python3 -m h100bench.control --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 [--seconds 1]

For each seed of ``--seeds``, a run of the cell with a short window (one
request or more, every number compared as a run compares it): the program's
readings, the lower ends of the limits. For each of ``--control-seeds`` also
the control's readings, the upper ends: the plain reference one precision
below the configuration's (fp8 under the bfloat16 UNet and VAE, TF32 under
the float32 text encoders, bfloat16 under the float32 embed) put in the
program's place. Prints a JSON line a seed, then the largest program
reading and the smallest control reading of each number. The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from h100bench import cells, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    cell = cells.load(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    lower, upper = {}, {}
    for seed in [int(s) for s in args.seeds.split(",")]:
        res = run.run_cell(cell, seed, args.seconds, False, "cuda:0",
                           started=run.time.perf_counter(), with_control=seed in controls)
        program = {k: v["value"] for k, v in res["checks"].items()}
        for k, v in program.items():
            lower[k] = max(lower.get(k, v), v)
        for k, v in res.get("control", {}).items():
            upper[k] = min(upper.get(k, v), v)
        print(json.dumps({"seed": seed, "correct": res["correct"], "program": program,
                          "control": res.get("control")}), flush=True)
    print(json.dumps({"lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
