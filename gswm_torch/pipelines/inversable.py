"""InversablePipeline — Z_T -> final latents, and image -> Z_T (PyTorch).

Port of ``gswm.pipelines.inversable`` for the extraction path:
  * ``generate(decode=False)``: DDIM denoising of a caller-given Z_T on the
    empty prompt at guidance 1.0;
  * ``image_to_latents``: 2x-1, then the VAE posterior mean x 0.18215,
    chunked over the batch;
  * ``invert``: exact DDIM inversion with the empty-prompt context and
    guidance 1.0 (the reference's extraction setting, extract.py:66-69);
  * ``extract_bits``: inversion + quantize / decrypt / vote.
The JAX scan becomes a Python loop over steps.  The scheduler state, the
alphas and ``to_eps`` stay float32 whatever the UNet's compute dtype.  Not
ported yet: classifier-free guidance, DPM++, the VAE decoder, refinement,
SDXL.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gswm_torch.config import GSConfig
from gswm_torch.core.decode import recover_message_bits
from gswm_torch.models.configs import PRESETS, ModelPreset
from gswm_torch.models.layers import init_random_
from gswm_torch.models.text import TextEncoder
from gswm_torch.models.unet import UNet2DCondition
from gswm_torch.models.vae import AutoencoderKL
from gswm_torch.schedulers.ddim import (
    ddim_inverse_plan,
    ddim_plan,
    ddim_step,
    to_eps,
)
from gswm_torch.schedulers.schedule import sd_schedule


def _build(cls, cfg, generator: torch.Generator):
    """Construct without torch's default init, then fill from ``generator``."""
    with torch.device("meta"):
        module = cls(cfg)
    module.to_empty(device=generator.device)
    init_random_(module, generator)
    return module.eval().requires_grad_(False)


class InversablePipeline:
    """One weight set; generate and invert on one device."""

    # VAE activations at 512x512 are the memory peak of the extraction path;
    # the encode runs over batch chunks of this many 512x512 images, scaled
    # down inversely with pixel count (the JAX package's rule).
    vae_chunk: int = 32

    def __init__(self, preset: ModelPreset | str = "sd-2-1-base", device="cpu",
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        """Random weights from ``generator`` (default: seed 0 on ``device``);
        ``models.bridge`` loads the JAX package's.  The UNet and the VAE
        compute in ``dtype``; the text encoder in float32."""
        if isinstance(preset, str):
            preset = PRESETS[preset]
        if preset.text2 is not None or preset.unet.addition_embed_dim:
            raise NotImplementedError(f"{preset.name}: SDXL is not ported yet")
        self.preset = preset
        self.device = torch.device(device)
        self.dtype = dtype
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.unet = _build(UNet2DCondition, preset.unet, generator).to(
            self.device, dtype)
        self.vae = _build(AutoencoderKL, preset.vae, generator).to(
            self.device, dtype)
        self.text = _build(TextEncoder, preset.text, generator).to(self.device)
        self.schedule = sd_schedule(prediction_type=preset.prediction_type)
        self._empty_ctx = None

    def reset_caches(self) -> None:
        """Drop the cached empty-prompt context (after new weights)."""
        self._empty_ctx = None

    # -- conditioning --------------------------------------------------------

    def encode_prompt_ids(self, input_ids) -> torch.Tensor:
        """(B, 77) token ids -> (B, 77, dim) float32 context."""
        with torch.inference_mode():
            return self.text(input_ids)

    def empty_context(self, batch: int = 1) -> torch.Tensor:
        """Context for the empty prompt, broadcast to ``batch`` rows: encoded
        ONCE per pipeline (every row is the same "" prompt)."""
        if self._empty_ctx is None:
            self._empty_ctx = self.encode_prompt_ids(self.text.empty_prompt_ids(1))
        c = self._empty_ctx
        return c.expand((batch,) + c.shape[1:])

    # -- the step loop -------------------------------------------------------

    @torch.inference_mode()
    def _run(self, latents, context, num_steps: int, invert: bool) -> torch.Tensor:
        plan = (ddim_inverse_plan if invert else ddim_plan)(self.schedule, num_steps)
        alphas = torch.from_numpy(np.stack(
            [plan.alpha_eval, plan.alpha_from, plan.alpha_to])).to(self.device)
        x = torch.as_tensor(latents).to(self.device, torch.float32)
        b = x.shape[0]
        pred_type = self.schedule.prediction_type
        for i, t in enumerate(plan.t_model.tolist()):
            a_eval, a_from, a_to = alphas[0, i], alphas[1, i], alphas[2, i]
            ts = torch.full((b,), t, dtype=torch.int32, device=self.device)
            eps = to_eps(x, self.unet(x, ts, context), a_eval, pred_type)
            x = ddim_step(x, eps, a_from, a_to)
        return x

    # -- public API ----------------------------------------------------------

    def generate(self, latents, num_steps: int = 50,
                 decode: bool = False) -> torch.Tensor:
        """Watermarked Z_T -> final latents (float32): DDIM on the empty
        prompt at guidance 1.0."""
        if decode:
            raise NotImplementedError("the VAE decoder is not ported yet")
        return self._run(latents, self.empty_context(latents.shape[0]), num_steps,
                         invert=False)

    def _vae_chunk_for(self, images) -> int:
        scale = max(1.0, images.shape[-2] * images.shape[-1] / (512 * 512))
        return max(1, int(self.vae_chunk / scale))

    @torch.inference_mode()
    def image_to_latents(self, images) -> torch.Tensor:
        """images (B,3,H,W) in [0,1] -> scaled posterior-MEAN latents, float32
        (extract.py:39-43 parity, including the 2x-1 normalization)."""
        x = 2.0 * torch.as_tensor(images).to(self.device, torch.float32) - 1.0
        c = self._vae_chunk_for(x)
        return torch.cat([self.vae.encode(ch) for ch in x.split(c)])

    def invert(self, images=None, latents=None, num_steps: int = 50) -> torch.Tensor:
        """image (or its latents) -> recovered Z_T, empty prompt, guidance 1."""
        if latents is None:
            latents = self.image_to_latents(images)
        ctx = self.empty_context(latents.shape[0])
        return self._run(latents, ctx, num_steps, invert=True)

    def extract_bits(self, cfg: GSConfig, images=None, latents=None,
                     num_steps: int = 50):
        """Inversion + quantize/decrypt/vote.  Returns ``(bits, z_T)``: voted
        message bits (B, message_bits) uint8 and the recovered init noise."""
        z_t = self.invert(images=images, latents=latents, num_steps=num_steps)
        return recover_message_bits(z_t, cfg), z_t
