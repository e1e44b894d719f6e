"""Device milliseconds of the VAE an image: the device time of the
operations launched within the ``vae.encoder`` and ``vae.decoder`` ranges
over the window's images (extraction runs the encoder, generation the
decoder)."""


def read(run, name):
    if run.trace is None:
        return None
    device_s = run.trace.device_s_in("vae.encoder") + run.trace.device_s_in("vae.decoder")
    return 1e3 * device_s / run.images if device_s > 0 else None
