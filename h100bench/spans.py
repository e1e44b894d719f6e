"""The program's own spans in a traced run.

gswm_torch opens a span where each layer's work starts
(``gswm_torch.utils.profiling.span``: ``gswm.unet``, ``gswm.groupnorm``,
``gswm.attn.self`` ...). The profiler records one as an ordinary host
operation of the thread that opened it, so ``trace.read`` hands it over in
``Trace.host_ops`` as ``(name, start, end)``, on the clock of the device's
records, nested in time inside the span open around it. A trace of a
program that opens no such span has none, and every function here then
returns nothing: an empty list, or 0. Nothing of gswm_torch is imported.
"""

from __future__ import annotations

import bisect


def spans(trace, names) -> list:
    """(start, end) of the host operations named ``names`` (a name, or a
    set of names) that lie in the trace's window, by their start."""
    names = {names} if isinstance(names, str) else set(names)
    w0, w1 = trace.window
    return sorted((s, e) for n, s, e in trace.host_ops if n in names and w0 <= s and e <= w1)


def _union(intervals: list) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def device_in(trace, intervals: list) -> tuple[int, float]:
    """(count, device seconds) of the device operations whose launch lies
    inside one of ``intervals``, bisecting on the launch time as
    ``Trace.device_s_in`` does; an operation without a launch time is left
    out."""
    merged = _union(intervals)
    starts = [s for s, _ in merged]
    count, total = 0, 0.0
    for _, s, e, launch in trace.device_ops:
        if launch is None:
            continue
        i = bisect.bisect_right(starts, launch) - 1
        if i >= 0 and launch <= merged[i][1]:
            count += 1
            total += e - s
    return count, total


def host_s_inside(trace, intervals: list, name: str) -> float:
    """Host seconds of the host operations named ``name`` that start inside
    one of ``intervals``, each cut at the end of the interval it is in."""
    merged = _union(intervals)
    starts = [s for s, _ in merged]
    total = 0.0
    for n, s, e in trace.host_ops:
        if n != name:
            continue
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s <= merged[i][1]:
            total += min(e, merged[i][1]) - s
    return total
