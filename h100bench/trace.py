"""What the traced run reads from ``torch.profiler``: the device's operations
(kernels, copies and fills), the benchmark's ranges, and the host's
operations, all on the profiler's one clock.

The profiler's raw records are read (``kineto_results.events()``), not its
event tree, whose building takes minutes on a trace of whole requests. A
device operation is tied to the host call that launched it by the CUDA
correlation id, which the launch's record and the device's carry alike
(``linked_correlation_id`` names the PyTorch operation); one without a
launch record inherits the launch time of the operation before it on the
device (the program runs one stream, in launch order). No trace file is
written.
"""

from __future__ import annotations

import bisect
import dataclasses


@dataclasses.dataclass
class Trace:
    """Times in seconds from the trace's start."""

    window: tuple            # (start, end) of the traced requests, host clock
    device_ops: list         # (name, start, end, launch time or None)
    ranges: list             # (name, start, end) of the benchmark's ranges
    host_ops: list           # (name, start, end) of the host's operations, main thread
    unlinked: int = 0        # device operations whose launch record was not found

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        busy, last = 0.0, self.window[0]
        for _, s, e, _ in sorted(self.device_ops, key=lambda o: o[1]):
            s, e = max(s, last), min(e, self.window[1])
            if e > s:
                busy += e - s
                last = e
        return busy

    def idle_gaps(self) -> list:
        """(start, end) of the window's spans in which no device operation ran."""
        gaps, last = [], self.window[0]
        for _, s, e, _ in sorted(self.device_ops, key=lambda o: o[1]):
            if s > last:
                gaps.append((last, min(s, self.window[1])))
            last = max(last, e)
        if last < self.window[1]:
            gaps.append((last, self.window[1]))
        return [g for g in gaps if g[1] > g[0]]

    def device_s_in(self, name: str) -> float:
        """Device seconds of the operations launched within ranges ``name``."""
        spans = sorted((s, e) for n, s, e in self.ranges if n == name)
        starts = [s for s, _ in spans]
        total = 0.0
        for _, s, e, launch in self.device_ops:
            if launch is None:
                continue
            i = bisect.bisect_right(starts, launch) - 1
            if i >= 0 and launch <= spans[i][1]:
                total += e - s
        return total

    def host_s_in(self, name: str) -> tuple[float, int]:
        """(host seconds, count) of the ranges ``name``."""
        spans = [(s, e) for n, s, e in self.ranges if n == name]
        return sum(e - s for s, e in spans), len(spans)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations by their total seconds, and the idle
        seconds by the host operation running when each gap opened."""
        ops = {}
        for name, s, e, _ in self.device_ops:
            ops[name] = ops.get(name, 0.0) + (e - s)
        hosts = sorted(self.host_ops, key=lambda o: o[1])
        starts = [o[1] for o in hosts]
        idle = {}
        for s, e in self.idle_gaps():
            name = self.host_op_at(s, hosts, starts)
            idle[name] = idle.get(name, 0.0) + (e - s)

        def first(d):
            return [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": first(ops), "idle_gaps": first(idle)}

    def host_op_at(self, t: float, hosts: list, starts: list) -> str:
        """The innermost of ``hosts`` (host operations sorted by their
        ``starts``) that runs at ``t``: the latest started one not yet ended;
        else the innermost range, marked "(python)" (the host ran Python
        code there); else "python"."""
        i = bisect.bisect_right(starts, t) - 1
        for name, s, e in reversed(hosts[max(i - 4000, 0):i + 1]):
            if e >= t:
                return name
        inside = [(s, n) for n, s, e in self.ranges if s <= t <= e]
        return f"{max(inside)[1]} (python)" if inside else "python"


def _device_kind(ev) -> str:
    return str(ev.device_type()).split(".")[-1].upper()


def read(prof, range_names, window_range: str = "request") -> Trace:
    """A ``Trace`` of the profiler ``prof`` after its window closed: its
    window from the first ``window_range`` range's start to the last one's
    end, ranges of ``range_names`` (and ``window_range``) kept."""
    events = prof.profiler.kineto_results.events()
    names = set(range_names) | {window_range}
    launches, device, ranges, host = {}, [], [], []
    threads = {}
    for ev in events:
        kind = _device_kind(ev)
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if kind == "CPU":
            if name in names:
                ranges.append((name, s, e))
                continue
            corr = ev.correlation_id()
            if corr > 0 and name.startswith("cu"):
                launches[corr] = s
                continue
            if ev.is_user_annotation():
                continue
            tid = ev.start_thread_id()
            threads[tid] = threads.get(tid, 0) + 1
            host.append((tid, name, s, e))
        elif kind == "CUDA":
            if name in names or ev.is_user_annotation():
                continue  # the device-side copy of a range
            device.append((name, s, e, ev.correlation_id()))
    main = max(threads, key=threads.get) if threads else None
    requests = [(s, e) for n, s, e in ranges if n == window_range]
    if not requests:
        raise RuntimeError(f"the trace holds no {window_range!r} range")
    t0, t1 = min(s for s, _ in requests), max(e for _, e in requests)
    sec = 1e-9
    ops, last, unlinked = [], None, 0
    for name, s, e, corr in sorted(device, key=lambda d: d[1]):
        launch = launches.get(corr)
        unlinked += launch is None
        launch = last if launch is None else launch
        last = launch
        ops.append((name, (s - t0) * sec, (e - t0) * sec,
                    None if launch is None else (launch - t0) * sec))
    return Trace(window=(0.0, (t1 - t0) * sec), device_ops=ops,
                 ranges=[(n, (s - t0) * sec, (e - t0) * sec) for n, s, e in ranges],
                 host_ops=[(n, (s - t0) * sec, (e - t0) * sec)
                           for tid, n, s, e in host if tid == main], unlinked=unlinked)
