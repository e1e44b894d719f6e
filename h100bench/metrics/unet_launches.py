"""Device operations launched a UNet forward: the kernels, copies and fills
whose launch lies inside a ``gswm.unet`` span (the program's own,
``UNet2DCondition.forward``), over the number of those spans. A count that
repeats exactly run to run: a CUDA graph, fusion or another route cuts it."""

from h100bench import spans


def read(run, name):
    if run.trace is None:
        return None
    unet = spans.spans(run.trace, "gswm.unet")
    launches, _ = spans.device_in(run.trace, unet)
    return launches / len(unet) if launches else None
