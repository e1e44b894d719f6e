"""Host milliseconds a UNet call: the host time of the ``unet`` ranges over
their number, the cost of enqueueing one forward, which a CUDA graph of
the step loop would cut."""


def read(run, name):
    if run.trace is None:
        return None
    host_s, calls = run.trace.host_s_in("unet")
    return 1e3 * host_s / calls if calls else None
