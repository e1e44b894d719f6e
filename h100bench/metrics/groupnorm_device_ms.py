"""Device milliseconds of GroupNorm an image: the device time of the
operations launched inside the ``gswm.groupnorm`` spans (the program's own,
``models/layers.py:GroupNorm32.forward``, in the UNet and the VAE: the
casts, the statistics and the apply step, whatever kernels run them) over
the window's images."""

from h100bench import spans


def read(run, name):
    if run.trace is None:
        return None
    _, device_s = spans.device_in(run.trace, spans.spans(run.trace, "gswm.groupnorm"))
    return 1e3 * device_s / run.images if device_s > 0 else None
