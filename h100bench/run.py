"""Run one cell of the benchmark once.

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A fresh process: it checks for the card (and fails without one: no CPU
fallback), builds or loads the port's kernels from the fixed cache inside
the checkout, makes the weights and every input on the card from
``--seed``, warms up on one request of the cell's own shapes (the end of
``setup_s``), then runs a closed loop of whole requests back to back for at
least ``--seconds`` (``--trace 1``: the mix's ``trace_requests`` requests
under ``torch.profiler``). After the window the program is freed and the
plain reference judges what the timed path produced (``check.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its limit;
the same numbers are the last lines of standard error. A run whose process
holds ``jax``, ``jaxlib``, ``flax`` or ``gswm`` after the window exits 3
and prints no result.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from h100bench import cells  # noqa: E402

# caches of what the program or PyTorch build, inside the checkout at fixed paths
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels"}
FORBIDDEN = ("jax", "jaxlib", "flax", "gswm")


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: cells.Cell
    requests: int
    images: int
    window_s: float
    setup_s: float
    peak_bytes: int
    trace: object = None


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that the benchmark's process may not hold."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: cells.Cell, seed: int, seconds: float, traced: bool, device,
             started: float = STARTED, with_control: bool = False) -> dict:
    """One run of ``cell`` on ``device``; the result's fields as printed.
    ``with_control`` (``control.py``, never the benchmark's own runs) adds
    ``control``: the same numbers of the reference computed one precision
    below the configuration's in the program's place."""
    import torch

    from h100bench import check, inputs, program

    dev = torch.device(device)
    marks = [("imports", time.perf_counter())]
    if dev.type == "cuda":
        from gswm_torch import native

        native.library()  # built into build/gswm_torch_kernels/ on a checkout's first run
        marks.append(("kernels", time.perf_counter()))
    states = inputs.make_states(cell.config, seed, dev)
    marks.append(("weights", time.perf_counter()))
    pipe = program.build(cell.config, states, dev)
    del states
    marks.append(("pipeline", time.perf_counter()))
    requests = inputs.Requests(cell.config, cell.mix, seed, dev)
    entry = program.Entry(pipe, cell.config, cell.mix, requests)
    capture = program.Capture(pipe, cell.config)

    def one(r: int) -> None:
        capture.begin()
        entry(r)
        capture.end()

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    one(-1)  # warm-up: the cell's own shapes, and no others
    sync()
    for kept in (entry.answers, entry.z_T, capture.latents, capture.context,
                 capture.text_embeds, capture.final):
        kept.clear()
    setup_s = time.perf_counter() - started
    marks.append(("warm-up", time.perf_counter()))
    print("set-up: " + ", ".join(f"{name} {t - before:.2f} s" for (name, t), before in
                                 zip(marks, [started] + [t for _, t in marks])), file=sys.stderr)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    tr = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        from h100bench import trace

        ranges = program.Ranges(pipe)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            # margins, so that the tracer keeps the device records at the
            # window's edges (chip_smoke.py's _check_one_kernel)
            time.sleep(0.3)
            for r in range(cell.mix["trace_requests"]):
                with torch.autograd.profiler.record_function("request"):
                    one(r)
                    sync()
            time.sleep(0.05)
        ranges.remove()
        tr = trace.read(prof, program.RANGES)
        n, window_s = cell.mix["trace_requests"], tr.window_s
        print(f"trace: {len(tr.device_ops)} device operations, {tr.unlinked} without a "
              f"launch record, {len(tr.ranges)} ranges, {len(tr.host_ops)} host operations",
              file=sys.stderr)
    else:
        t0, cpu0 = time.perf_counter(), time.process_time()
        ends = []
        while True:
            one(len(ends))
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        sync()
        window_s = time.perf_counter() - t0
        n = len(ends)
        print(f"window: {n} requests, {window_s:.4f} s, process CPU "
              f"{time.process_time() - cpu0:.4f} s, load {os.getloadavg()}, "
              f"ends {[round(e, 4) for e in ends]}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    captured = {"latents": capture.latents, "context": capture.context,
                "text_embeds": capture.text_embeds, "final": capture.final,
                "z_T": entry.z_T, "answers": entry.answers}
    capture.remove()
    del pipe, entry, capture
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    if with_control:
        numbers, control = check.judge(cell, seed, dev, captured, n, requests, control=True)
    else:
        numbers, control = check.judge(cell, seed, dev, captured, n, requests), None
    correct, checks = check.verdict(numbers, cell.limits)

    run = Run(cell=cell, requests=n, images=n * cell.mix["batch"], window_s=window_s,
              setup_s=setup_s, peak_bytes=peak, trace=tr)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = cells.reader(m["name"])(run, m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": n, "failed": 0, "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                         "count": cell.chips, "memory_peak_bytes": int(peak)}}
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    if control is not None:
        result["control"] = control
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (cells.ROOT / "gswm_torch" / "__init__.py").exists():
        print(f"h100bench: no gswm_torch in {cells.ROOT}: the program measured is the "
              "checkout's own", file=sys.stderr)
        return 2
    for var, sub in CACHES.items():
        os.environ[var] = str(cells.ROOT / "build" / sub)
    cell = cells.load(args.workload)

    import torch

    torch.set_num_threads(1)  # one process, few threads: the host path is one thread
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"h100bench: the cell needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0")
    found = forbidden_modules()
    if found:
        print(f"h100bench: the process holds {found} after the window", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
