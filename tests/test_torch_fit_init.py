"""The tiny VAE fitted from the port's own random init, as
``gswm_torch/tools/run_robustness_sweep.py --preset tiny`` fits it:
``fit_vae_roundtrip(pipe)`` with its defaults (600 steps, batch 16, 8x8
latents, the port's draws) on a pipeline built from a seed
(``models.layers.init_random_``).  tests/test_torch_fitting.py holds the
fit to the JAX package's on the reference's weights and draws; this file
holds the path the port runs alone, at several seeds, through the closed
loop of tests/test_pipeline.py:61-79 (the reference reads 1.0 there):
Z_T -> 20-step generate -> decode -> encode -> 20-step inversion -> vote.

Each seed also prints the images' mean pixel and the accuracy after
brightness x 2.5 (``distortions.device.brightness``), the two readings
that tell where a fit puts the decoder's output range.  About a minute of
CPU a seed.
"""

import numpy as np
import pytest
import torch

from gswm_torch.config import GSConfig
from gswm_torch.core import bits as bitops
from gswm_torch.core.decode import recover_message_bits
from gswm_torch.core.embed import embed_latents
from gswm_torch.distortions.device import brightness
from gswm_torch.pipelines import InversablePipeline
from gswm_torch.utils import fitting

torch.set_num_threads(2)
IMAGES = 3  # Z_T a seed, one batch


def _vote_accuracy(pipe, images, cfg, msg) -> list:
    z_back = pipe.invert(images=images, num_steps=20)
    voted = recover_message_bits(z_back, cfg).numpy()
    return np.mean(voted == bitops.bytes_to_bits(msg)[None], axis=1).tolist()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_closed_loop_on_a_vae_fitted_from_the_port_init(seed):
    pipe = InversablePipeline("tiny", device="cpu", dtype=torch.float32,
                              generator=torch.Generator().manual_seed(seed))
    fitting.fit_vae_roundtrip(pipe)
    cfg = GSConfig(key_hex="22" * 32, nonce_hex="33" * 16, message="lthero",
                   width=16, height=16, vae_scale=2, message_bits=32)
    z_t, msg = embed_latents(cfg, generator=torch.Generator().manual_seed(6),
                             batch=IMAGES, device="cpu")
    img = pipe.generate(z_t, guidance_scale=1.0, num_steps=20)
    assert img.shape == (IMAGES, 3, 16, 16)
    acc = _vote_accuracy(pipe, img, cfg, msg)
    bright = _vote_accuracy(pipe, brightness(img, 2.5), cfg, msg)
    print(f"seed {seed}: closed-loop bit accuracy {acc}, after brightness x 2.5 "
          f"{bright}, mean pixel {img.mean(dim=(1, 2, 3)).tolist()}")
    assert float(np.mean(acc)) > 0.9, acc
