"""The whole request's share of the card's bf16 peak, in %: the model FLOPs
of every request in the traced window (``count.request``: UNet forwards,
VAE encoder or decoder, text encoders, counted on the plain reference) over
the window's wall times 989e12 FLOP/s."""

from h100bench import count


def read(run, name):
    if run.trace is None:
        return None
    flops, _ = count.request(run.cell.config, run.cell.mix)
    return 100.0 * run.requests * flops / (run.trace.window_s * count.PEAK_BF16)
