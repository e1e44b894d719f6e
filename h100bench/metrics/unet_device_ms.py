"""Device milliseconds of the UNet an image-forward: the device time of the
operations launched within the ``unet`` ranges, over the image-forwards
(requests x steps x images; a guided step is one image-forward an image,
at UNet batch 2)."""


def read(run, name):
    if run.trace is None:
        return None
    device_s = run.trace.device_s_in("unet")
    forwards = run.requests * run.cell.mix["steps"] * run.cell.mix["batch"]
    return 1e3 * device_s / forwards if device_s > 0 else None
