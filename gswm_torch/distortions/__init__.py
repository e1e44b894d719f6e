"""Robustness bench: the reference's 16-attack distortion suite
(`distortions`:17-34, credited there to the WAVES benchmark) with two
backends, as ``gswm.distortions`` has them:

  * ``host``   — PIL/numpy exact implementations (bit-faithful JPEG via
                 libjpeg, PIL resampling) for report-grade numbers;
  * ``device`` — batched PyTorch implementations that run the whole sweep on
                 the card (JPEG as a DCT-quantization round trip).

Also provides the ``utils`` module (set_random_seed / to_tensor / to_pil).
Imports where there is no PIL: the host functions import it when called.
"""

from gswm_torch.distortions.attacks import (  # noqa: F401
    DISTORTION_STRENGTH_PARAS,
    apply_distortion,
    apply_single_distortion,
    apply_multiple_distortions,
    relative_strength_to_absolute,
)
from gswm_torch.distortions import device as device_attacks  # noqa: F401
