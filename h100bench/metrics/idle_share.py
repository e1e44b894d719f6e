"""The device's idle share of the traced window, in %: 1 - (the seconds in
which a kernel, copy or fill ran) / the window's wall, as
gswm_torch/tools/profile_paths.py ``profiled()`` computes it. The
profiler's own host cost inflates it a little; the untraced rate stands
beside it."""


def read(run, name):
    if run.trace is None:
        return None
    busy = run.trace.busy_s()
    return 100.0 * (1.0 - busy / run.trace.window_s) if busy > 0 else None
