"""Tracing and profiling hooks (the port of ``gswm.utils.profiling``).

  * ``span`` — a named interval of the host thread, recorded on the
    profiler's clock while a ``torch.profiler`` session records and free
    otherwise. The program opens one wherever a layer's work starts (the
    request, the step loop, the UNet, GroupNorm, attention: ``gswm.*``);
    they reach a trace as ordinary host operations, which
    ``h100bench/spans.py`` and the benchmark's ``program_span`` metrics read;
  * ``stage`` — wall-clock timer per pipeline stage (embed / vae / unet-loop
    / decode) with a process-global report, inside a ``span`` of its name;
  * ``trace`` — ``torch.profiler`` around a block, written as a Chrome trace;
  * ``device_stats`` — live device memory per card.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

_STAGES: dict[str, list[float]] = defaultdict(list)


def span(name: str):
    """A context manager that records ``name``, its start and its end on the
    profiler's clock while a ``torch.profiler`` session records: a host
    operation of this thread, its parent the span open around it (a
    request's root span, ``gswm.extract_bits`` or ``gswm.generate``, is the
    request's identifier). Without a profiler it costs about what
    ``contextlib.nullcontext`` costs (0.39-0.50 against 0.31-0.41 µs an
    enter and exit on an H100 machine's host). It never synchronizes,
    allocates or touches the device, and closes on an exception.

    ``torch.autograd.profiler.record_function`` costs over ten times as much
    without a profiler (6.2-6.5 µs there) and is recorded as a user
    annotation, which trace readers keep apart from the host's operations:
    hence the private ``_RecordFunctionFast``, used here and nowhere else."""
    return torch._C._profiler._RecordFunctionFast(name)


@contextlib.contextmanager
def stage(name: str, sync: bool = True, device="cuda"):
    """Time a pipeline stage; ``sync`` waits for the work queued on a CUDA
    ``device`` so the number means device time, not enqueue time (the CPU
    has nothing queued to wait on).  The stage is also a ``span``."""
    with span(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync and torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            _STAGES[name].append(time.perf_counter() - t0)


def stage_report(reset: bool = False) -> dict:
    rep = {
        name: {
            "count": len(ts),
            "total_s": round(sum(ts), 4),
            "mean_s": round(sum(ts) / len(ts), 4),
        }
        for name, ts in _STAGES.items()
        if ts
    }
    if reset:
        _STAGES.clear()
    return rep


@contextlib.contextmanager
def trace(log_dir: str = os.path.join("build", "gswm_torch-trace"), device="cuda"):
    """``torch.profiler`` over the block (the host's activity, and the
    card's where ``device`` is a CUDA device); the Chrome trace is written to
    ``log_dir/trace.json``.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_stats(devices=("cuda",)) -> list[dict]:
    """Memory of each CUDA device in ``devices`` (raises without a card),
    under the reference's keys: ``bytes_in_use``, ``peak_bytes_in_use``
    (``torch.cuda.memory_stats``), ``bytes_limit`` (the card's memory,
    ``mem_get_info``) and ``bytes_free``."""
    out = []
    for d in devices:
        dev = torch.device(d)
        free, total = torch.cuda.mem_get_info(dev)
        s = torch.cuda.memory_stats(dev)
        out.append({
            "device": str(dev),
            "bytes_in_use": s.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak"),
            "bytes_limit": total,
            "bytes_free": free,
        })
    return out
