"""InversablePipeline — Z_T -> image, and image -> Z_T (PyTorch).

Port of ``gswm.pipelines.inversable``:
  * ``generate``: DDIM or DPM++ denoising of a caller-given Z_T on a prompt
    (token ids or a context), with classifier-free guidance (one UNet call
    on the cond/uncond pair), then the VAE decoder, chunked over the batch;
  * ``image_to_latents``: 2x-1, then the VAE posterior mean x 0.18215,
    chunked over the batch;
  * ``invert``: inversion with the empty-prompt context and guidance 1.0
    (the reference's extraction setting, extract.py:66-69), DDIM or DPM++,
    with optional fixed-point refinement of each step;
  * ``extract_bits``: inversion + quantize / decrypt / vote.
SDXL presets carry a second text encoder (contexts concatenated on the
feature axis) and the addition embeddings' ``added_cond``: the second
encoder's pooled output of the empty prompt and ``time_ids`` from the
image size.  The JAX scan becomes a Python loop over steps.  The scheduler
state, the alphas and ``to_eps`` stay float32 whatever the UNet's compute
dtype.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from gswm_torch.config import GSConfig
from gswm_torch.core.decode import recover_message_bits
from gswm_torch.models import loader
from gswm_torch.models.configs import PRESETS, ModelPreset
from gswm_torch.models.layers import VAE_FLASH_MIN_TOKENS, init_random_, to_compute_dtype_
from gswm_torch.models.text import TextEncoder
from gswm_torch.models.unet import UNet2DCondition
from gswm_torch.models.vae import AutoencoderKL
from gswm_torch.schedulers import SCHEDULERS
from gswm_torch.schedulers.ddim import ddim_step, to_eps
from gswm_torch.schedulers.dpm import dpm_init_carry, dpm_step
from gswm_torch.ops.attention import (FUSED_QKV_MAX_SEQ, FUSED_QKV_MIN_SEQ, KERNEL_DTYPES,
                                      kernel_takes_head_dim)
from gswm_torch.schedulers.schedule import sd_schedule
from gswm_torch.utils.profiling import span


def _build(cls, cfg, generator: Optional[torch.Generator]):
    """Construct without torch's default init, then fill from ``generator``;
    left on the meta device without one."""
    with torch.device("meta"):
        module = cls(cfg)
    if generator is not None:
        module.to_empty(device=generator.device)
        init_random_(module, generator)
    return module.eval().requires_grad_(False)


def _load(cls, cfg, state: dict, what: str):
    """Construct on the meta device and take ``state``'s tensors by
    assignment: nothing is filled that the checkpoint overwrites."""
    with torch.device("meta"):
        module = cls(cfg)
    return loader.load_state_(module, state, what).eval().requires_grad_(False)


def _check_served_on_cuda(preset: ModelPreset, dtype: torch.dtype) -> None:
    """Refuse, before anything is built, what the CUDA kernels do not serve.
    At the preset's default resolution every UNet self-attention of
    ``FUSED_QKV_MIN_SEQ`` tokens or more runs a kernel, which takes the
    head dims ``kernel_takes_head_dim`` (d % 8 == 0, 8 <= d <= 512: SD 1.x's
    40, 80 and 160, SD 2.x's and SDXL's 64), and at the fused-qkv sites'
    token counts a width the projection GEMM takes (a multiple of 64); the
    VAE's mid attention runs the split kernel at d = 512 above
    ``VAE_FLASH_MIN_TOKENS``.  In bfloat16 and in float32 the kernels serve
    all of them on every route the reference's switches pick (float32:
    csrc/qkv_proj_f32.cu's GEMM and csrc/flash_f32.cu's core in the natural,
    pair-packed and transposed layouts and with the log-sum-exp: sd-2-1,
    sd-2-0, sd-1-4 and sdxl-base and their base presets, under every switch
    set, the ring and the GroupNorm op too); no other dtype has a kernel.  A
    preset that stays below every kernel (``tiny``) runs plain attention in
    any dtype."""
    unet = preset.unet
    latent = preset.default_resolution // 8
    channels = unet.block_out_channels
    sites = [(level, ch) for level, ch in enumerate(channels)
             if unet.cross_attn_levels[level]]
    sites.append((len(channels) - 1, channels[-1]))  # the mid block
    reached = [((latent >> level) ** 2, ch, ch // unet.heads_for(ch))
               for level, ch in sites if (latent >> level) ** 2 >= FUSED_QKV_MIN_SEQ]
    vae_tokens = latent ** 2  # the VAE's mid block runs at the latent's size
    if not reached and vae_tokens <= VAE_FLASH_MIN_TOKENS:
        return
    refused = []
    for tokens, ch, d in reached:
        if not kernel_takes_head_dim(d):
            refused.append(f"heads {d} wide")
        if tokens <= FUSED_QKV_MAX_SEQ and ch % 64:
            refused.append(f"a fused-qkv width of {ch}")
    if refused:
        raise NotImplementedError(
            f"{preset.name} on a CUDA device: its self-attention has "
            f"{', '.join(sorted(set(refused)))}, and the attention kernels take head "
            "dims d % 8 == 0 up to 512 and fused-qkv widths that are multiples of 64; "
            'run it with device="cpu"')
    if dtype not in KERNEL_DTYPES:
        raise NotImplementedError(
            f"{preset.name} in {dtype} on a CUDA device: the attention kernels take "
            "torch.bfloat16 and torch.float32; use one of them, or device=\"cpu\"")


@contextlib.contextmanager
def exact_float32(device, dtype: torch.dtype):
    """Within it, ``dtype`` float32 on a CUDA ``device`` computes in full
    float32: PyTorch's float32 matrix products may run in TF32 where
    ``torch.backends.cuda.matmul.allow_tf32`` allows it, and its cuDNN
    convolutions do by default (``torch.backends.cudnn.allow_tf32`` is
    True), keeping ~10 bits of mantissa.  Both are set False for the
    block's duration and restored after it; elsewhere it changes nothing."""
    if torch.device(device).type != "cuda" or dtype != torch.float32:
        yield
        return
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _exact_float32(method):
    """Run a pipeline method under ``exact_float32`` of its device and dtype."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with exact_float32(self.device, self.dtype):
            return method(self, *args, **kwargs)
    return run


@dataclasses.dataclass
class PipelineOutput:
    """Generation result carrying the init noise (gswm/pipelines/inversable.py:
    PipelineOutput, the reference's ModifiedStableDiffusionPipelineOutput)."""

    images: torch.Tensor  # (B, 3, H, W) in [0, 1]
    nsfw_content_detected: list
    init_latents: torch.Tensor  # the Z_T that seeded generation


class InversablePipeline:
    """One weight set; generate and invert on one device."""

    # VAE activations are the memory peak outside the step loop: encode and
    # decode run over batch chunks of this many 512x512 images, scaled down
    # inversely with pixel count and, for decode, by 8 more (the JAX
    # package's rule, gswm/pipelines/inversable.py:330-348).  Chunking does
    # not change results.
    vae_chunk: int = 32

    def __init__(self, preset: ModelPreset | str = "sd-2-1-base", device="cuda",
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None,
                 model_dir: Optional[str] = None,
                 weights_dtype: Optional[torch.dtype] = None):
        """On the card unless ``device`` names another (``"cpu"``; ``"meta"``
        builds the modules and allocates nothing).  Weights from a local
        diffusers-layout ``model_dir`` (``models.loader``), else random from
        ``generator`` (default: seed 0 on ``device``); ``models.bridge``
        loads the JAX package's.  The UNet and the VAE compute in ``dtype``
        with their norms' parameters kept float32; the text encoders in
        float32.  ``weights_dtype`` rounds every floating parameter of the
        UNet and the VAE through that dtype, norms too, each held in its
        compute dtype after (the JAX package's ``_cast_floating``).  On a
        CUDA device only what the kernels serve is built
        (``_check_served_on_cuda``): bfloat16 and float32 at head dims
        d % 8 == 0 up to 512 (SD 1.x's 40, 80, 160; SD 2.x's and SDXL's 64;
        the VAE's 512), so every preset in either, under every attention
        switch set (``ops.attention.route_self_attention``); a float32
        pipeline's calls there run with TF32 off (``exact_float32``)."""
        if isinstance(preset, str):
            preset = PRESETS[preset]
        self.preset = preset
        self.device = torch.device(device)
        self.dtype = dtype
        self.weights_dtype = weights_dtype
        if self.device.type == "cuda":
            _check_served_on_cuda(preset, dtype)
        parts = {"unet": (UNet2DCondition, preset.unet), "vae": (AutoencoderKL, preset.vae),
                 "text": (TextEncoder, preset.text)}
        if preset.text2 is not None:
            parts["text2"] = (TextEncoder, preset.text2)
        self.text2 = self.text2_projection = None
        if model_dir is not None:
            states = loader.load_pipeline_states(model_dir, sdxl=preset.text2 is not None)
            projection = states.pop("text2_projection", None)
            if projection is not None:
                self.text2_projection = projection.to(self.device)
            modules = {name: _load(cls, cfg, states[name], name)
                       for name, (cls, cfg) in parts.items()}
        else:
            if generator is None and self.device.type != "meta":
                generator = torch.Generator(device=self.device).manual_seed(0)
            modules = {name: _build(cls, cfg, generator) for name, (cls, cfg) in parts.items()}
        for name, module in modules.items():
            if name in ("unet", "vae"):
                module = to_compute_dtype_(module, self.device, dtype)
            setattr(self, name, module.to(self.device))
        self.schedule = sd_schedule(prediction_type=preset.prediction_type)
        self.weights_loaded_()

    def weights_loaded_(self) -> None:
        """After new weights: round them through ``weights_dtype`` and drop
        the cached empty-prompt context and pooled text."""
        if self.weights_dtype is not None:
            for module in (self.unet, self.vae):
                for p in module.parameters():
                    if p.is_floating_point():
                        p.data = p.data.to(self.weights_dtype).to(p.dtype)
        self.reset_caches()

    def reset_caches(self) -> None:
        """Drop the cached empty-prompt context and pooled text."""
        self._empty_ctx = None
        self._empty_pooled = None

    # -- conditioning --------------------------------------------------------

    @_exact_float32
    def encode_prompt_ids(self, input_ids, input_ids2=None) -> torch.Tensor:
        """(B, 77) token ids -> (B, 77, dim) float32 context; with a second
        encoder (SDXL) both contexts concatenated on the feature axis, the
        second's ids ``input_ids2`` (default ``input_ids``)."""
        with span("gswm.text"), torch.inference_mode():
            h = self.text(input_ids)
            if self.text2 is not None:
                h2 = self.text2(input_ids if input_ids2 is None else input_ids2)
                h = torch.cat([h, h2], dim=-1)
            return h

    def empty_context(self, batch: int = 1) -> torch.Tensor:
        """Context for the empty prompt, broadcast to ``batch`` rows: encoded
        ONCE per pipeline (every row is the same "" prompt)."""
        if self._empty_ctx is None:
            self._empty_ctx = self.encode_prompt_ids(self.text.empty_prompt_ids(1))
        c = self._empty_ctx
        return c.expand((batch,) + c.shape[1:])

    @_exact_float32
    def pooled_empty_text(self, batch: int = 1) -> torch.Tensor:
        """SDXL's pooled conditioning of the empty prompt: the second
        encoder's pooled output of "" (through ``text2_projection`` when a
        checkpoint gave one), encoded once and broadcast to ``batch`` rows."""
        if self._empty_pooled is None:
            enc = self.text2 if self.text2 is not None else self.text
            with span("gswm.text"), torch.inference_mode():
                self._empty_pooled = enc.pooled(enc.empty_prompt_ids(1),
                                                projection=self.text2_projection)
        p = self._empty_pooled
        return p.expand((batch,) + p.shape[1:])

    def default_added_cond(self, batch: int, height: int, width: int,
                           pooled_text=None) -> Optional[dict]:
        """SDXL micro-conditioning (None for other presets): ``time_ids`` =
        (orig h, orig w, crop 0, 0, target h, target w) in float32, and
        ``text_embeds`` the empty prompt's pooled output unless the caller
        gives its own.  The JAX package conditions ``generate`` on the empty
        prompt's pooled output even when prompt ids are given: kept."""
        if not self.preset.unet.addition_embed_dim:
            return None
        if pooled_text is None:
            pooled_text = self.pooled_empty_text(batch)
        tid = torch.tensor([[height, width, 0, 0, height, width]], dtype=torch.float32,
                           device=self.device)
        return {"text_embeds": torch.as_tensor(pooled_text, device=self.device),
                "time_ids": tid.expand(batch, 6)}

    def _added_cond_for(self, latents) -> Optional[dict]:
        """``default_added_cond`` at the image size of ``latents``."""
        f = 2 ** (len(self.preset.vae.block_out_channels) - 1)
        return self.default_added_cond(latents.shape[0], latents.shape[-2] * f,
                                       latents.shape[-1] * f)

    # -- the step loop -------------------------------------------------------

    @_exact_float32
    @torch.inference_mode()
    def _run(self, latents, context, num_steps: int, invert: bool,
             scheduler: str = "DDIM", uncond_context=None,
             guidance_scale: float = 1.0, refine: int = 0,
             added_cond: Optional[dict] = None) -> torch.Tensor:
        """The denoise (or inversion) loop.  With ``uncond_context`` each
        step runs the UNet once on the (uncond, cond) pair (``added_cond``
        doubled with it) and combines out_u + g (out_c - out_u) on its
        float32 output before ``to_eps``.
        ``refine`` (inversion only) re-takes each step from the same
        pre-step state with eps re-evaluated on the current estimate."""
        with span("gswm.loop"):
            plan = SCHEDULERS[scheduler][1 if invert else 0](self.schedule, num_steps)
            alphas = torch.from_numpy(np.stack(
                [plan.alpha_eval, plan.alpha_from, plan.alpha_to])).to(self.device)
            x = torch.as_tensor(latents).to(self.device, torch.float32)
            pred_type = self.schedule.prediction_type
            use_dpm = scheduler == "DPMs"
            guided = uncond_context is not None
            ctx = torch.cat([uncond_context, context]) if guided else context
            added = added_cond
            if guided and added is not None:
                added = {k: torch.cat([v, v]) for k, v in added.items()}

            def eval_eps(x, t, a_eval):
                if guided:
                    out_u, out_c = self.unet(torch.cat([x, x]), t, ctx, added).chunk(2)
                    out = out_u + guidance_scale * (out_c - out_u)
                else:
                    out = self.unet(x, t, ctx, added)
                return to_eps(x, out, a_eval, pred_type)

            def step(x, eps, a_from, a_to, carry, first):
                if use_dpm:
                    return dpm_step(x, eps, a_from, a_to, carry, first)
                return ddim_step(x, eps, a_from, a_to), carry

            carry = dpm_init_carry(x.shape, self.device) if use_dpm else None
            first_order = plan.extras.get("first_order")
            for i, t in enumerate(plan.t_model.tolist()):
                with span("gswm.step"):
                    a_eval, a_from, a_to = alphas[0, i], alphas[1, i], alphas[2, i]
                    first = bool(first_order[i]) if use_dpm else False
                    ts = torch.full((), t, dtype=torch.int32, device=self.device)
                    x_next, new_carry = step(x, eval_eps(x, ts, a_eval), a_from, a_to,
                                             carry, first)
                    for _ in range(refine if invert else 0):
                        x_next, new_carry = step(x, eval_eps(x_next, ts, a_eval), a_from,
                                                 a_to, carry, first)
                    x, carry = x_next, new_carry
            return x

    # -- public API ----------------------------------------------------------

    def generate(self, latents, context=None, prompt_ids=None,
                 guidance_scale: float = 7.5, num_steps: int = 50,
                 scheduler: str = "DDIM", decode: bool = True) -> torch.Tensor:
        """Watermarked Z_T -> images (B, 3, H, W) in [0, 1], float32, or the
        final latents with ``decode=False``.  The prompt is ``context`` or
        ``prompt_ids`` (B, 77) token ids, else the empty prompt; guidance
        1.0 (or None) runs the UNet on the prompt alone."""
        with span("gswm.generate"):
            b = latents.shape[0]
            if context is None:
                context = (self.encode_prompt_ids(prompt_ids) if prompt_ids is not None
                           else self.empty_context(b))
            guided = guidance_scale is not None and guidance_scale != 1.0
            out = self._run(latents, context, num_steps, invert=False,
                            scheduler=scheduler,
                            uncond_context=self.empty_context(b) if guided else None,
                            guidance_scale=guidance_scale if guided else 1.0,
                            added_cond=self._added_cond_for(latents))
            return self._vae_chunked(out, self.decode_image) if decode else out

    def generate_with_init(self, latents, **kw) -> PipelineOutput:
        """``generate`` that also returns the init latents."""
        images = self.generate(latents, **kw)
        return PipelineOutput(images=images,
                              nsfw_content_detected=[False] * images.shape[0],
                              init_latents=torch.as_tensor(latents))

    @_exact_float32
    @torch.inference_mode()
    def decode_image(self, latents) -> torch.Tensor:
        """Scaled latents -> float32 images in [0, 1], one VAE call."""
        x = torch.as_tensor(latents).to(self.device, torch.float32)
        return torch.clamp(self.vae.decode(x) * 0.5 + 0.5, 0.0, 1.0)

    def _vae_chunk_for(self, x) -> int:
        hw = x.shape[-2] * x.shape[-1]
        decode = x.shape[1] == self.preset.vae.latent_channels
        if decode:  # activations grow to image size at the decoder's output
            f = 2 ** (len(self.preset.vae.block_out_channels) - 1)
            hw *= f * f
        scale = max(1.0, hw / (512 * 512))
        if decode:
            scale *= 8.0
        return max(1, int(self.vae_chunk / scale))

    @_exact_float32
    @torch.inference_mode()
    def _vae_chunked(self, x, method) -> torch.Tensor:
        return torch.cat([method(ch) for ch in x.split(self._vae_chunk_for(x))])

    def image_to_latents(self, images) -> torch.Tensor:
        """images (B,3,H,W) in [0,1] -> scaled posterior-MEAN latents, float32
        (extract.py:39-43 parity, including the 2x-1 normalization)."""
        x = 2.0 * torch.as_tensor(images).to(self.device, torch.float32) - 1.0
        return self._vae_chunked(x, self.vae.encode)

    def invert(self, images=None, latents=None, num_steps: int = 50,
               scheduler: str = "DDIM", refine: int = 0) -> torch.Tensor:
        """image (or its latents) -> recovered Z_T, empty prompt, guidance 1;
        ``refine`` adds fixed-point iterations per step."""
        if latents is None:
            latents = self.image_to_latents(images)
        ctx = self.empty_context(latents.shape[0])
        return self._run(latents, ctx, num_steps, invert=True,
                         scheduler=scheduler, refine=refine,
                         added_cond=self._added_cond_for(latents))

    def extract_bits(self, cfg: GSConfig, images=None, latents=None,
                     num_steps: int = 50, scheduler: str = "DDIM",
                     refine: int = 0):
        """Inversion + quantize/decrypt/vote.  Returns ``(bits, z_T)``: voted
        message bits (B, message_bits) uint8 and the recovered init noise."""
        with span("gswm.extract_bits"):
            z_t = self.invert(images=images, latents=latents, num_steps=num_steps,
                              scheduler=scheduler, refine=refine)
            return recover_message_bits(z_t, cfg), z_t

    # -- reference-pyc API parity (gswm/pipelines/inversable.py:467-528) -----
    # Thin aliases matching InversableStableDiffusionPipeline /
    # ModifiedStableDiffusionPipeline method names, so reference-derived code
    # ports by renaming imports only.  Nothing in the port calls
    # get_text_embedding (nor eval.metrics.message_hex_to_bits): they are
    # kept for that parity alone, and a simplicity pass may drop them
    # together.

    def get_random_latents(self, generator: Optional[torch.Generator] = None,
                           batch: int = 1, height: int = 512,
                           width: int = 512) -> torch.Tensor:
        """N(0, 1) float32 latents (batch, latent_channels, height/f,
        width/f) on the pipeline's device, from ``generator`` (default: seed
        0 on that device; the reference's ``rng=`` default is key 0)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        f = 2 ** (len(self.preset.vae.block_out_channels) - 1)
        return torch.randn((batch, self.preset.vae.latent_channels, height // f,
                            width // f), generator=generator, device=self.device)

    def get_text_embedding(self, prompt_ids) -> torch.Tensor:
        return self.encode_prompt_ids(prompt_ids)

    @_exact_float32
    @torch.inference_mode()
    def get_image_latents(self, image, sample: bool = False,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """VAE-encode images in [0, 1]; ``sample=False`` (default) is the
        posterior MEAN the extraction path depends on (extract.py:39-43),
        ``sample=True`` adds exp(logvar / 2) x N(0, 1) from ``generator``
        (default: seed 0 on the pipeline's device)."""
        x = 2.0 * torch.as_tensor(image).to(self.device, torch.float32) - 1.0
        mean, logvar = self.vae.encode_moments(x)
        if sample:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            mean = mean + torch.exp(0.5 * logvar) * torch.randn(
                mean.shape, generator=generator, device=mean.device)
        return mean * self.preset.vae.scaling_factor

    def backward_diffusion(self, latents, context=None, guidance_scale=1.0,
                           num_inference_steps: int = 50,
                           reverse_process: bool = False,
                           scheduler: str = "DDIM") -> torch.Tensor:
        """One name, both directions (the pyc's backward_diffusion had a
        reverse_process flag): False = denoise, True = invert."""
        if reverse_process:
            return self.invert(latents=latents, num_steps=num_inference_steps,
                               scheduler=scheduler)
        return self.generate(latents, context=context, guidance_scale=guidance_scale,
                             num_steps=num_inference_steps, scheduler=scheduler,
                             decode=False)

    @staticmethod
    def torch_to_numpy(x) -> np.ndarray:
        """Name parity; any tensor or array -> numpy."""
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
        return np.asarray(x)
