"""Tree-Ring watermark toolkit — the port of ``gswm.treering``: parity with
the reference's compiled-only ``optim_utils`` module (SURVEY.md §2.3), which
carries the competing FFT-ring watermarking method for comparison experiments.

All frequency-domain ops are ``torch.fft`` and batched, on the device of the
latents; detection p-values use the noncentral-chi-square tail on host (scipy)
exactly like the original ``get_p_value``.
"""

from gswm_torch.treering.core import (  # noqa: F401
    get_watermarking_mask,
    get_watermarking_pattern,
    inject_watermark,
    eval_watermark,
    get_p_value,
)
