"""Host milliseconds a UNet forward takes to enqueue: the host time of the
``gswm.unet`` spans (the program's own, ``UNet2DCondition.forward``) less
the time the host spent inside them blocked on a full launch queue (the
profiler's ``Command Buffer Full`` operations), over the number of spans.
Where the card is the bottleneck, the span's own length is the device's
time a forward; this is the host's cost, which a CUDA graph of the step
loop or fewer launches would cut."""

from h100bench import spans

QUEUE_FULL = "Command Buffer Full"


def read(run, name):
    if run.trace is None:
        return None
    unet = spans.spans(run.trace, "gswm.unet")
    if not unet:
        return None
    host_s = sum(e - s for s, e in unet) - spans.host_s_inside(run.trace, unet, QUEUE_FULL)
    return 1e3 * host_s / len(unet)
