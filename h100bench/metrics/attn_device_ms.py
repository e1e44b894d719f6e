"""Device milliseconds of the UNet's attention an image-forward: the device
time of the operations launched inside the ``gswm.attn.self`` and
``gswm.attn.cross`` spans (the program's own, ``models/layers.py:
Attention.forward``: projections, the core on every route, the out
projection) over the image-forwards (requests x steps x images, as
``unet_device_ms`` counts them). Beside ``attn_roofline``, which counts the
flash kernels alone, this is the whole sub-layer, cross-attention and the
products in cuBLAS included."""

from h100bench import spans

SPANS = ("gswm.attn.self", "gswm.attn.cross")


def read(run, name):
    if run.trace is None:
        return None
    _, device_s = spans.device_in(run.trace, spans.spans(run.trace, SPANS))
    forwards = run.requests * run.cell.mix["steps"] * run.cell.mix["batch"]
    return 1e3 * device_s / forwards if device_s > 0 else None
