"""ComfyUI node pair — surface parity with ComfyUI_GSWaterMark/nodes.py (the
port of ``gswm.integrations.comfyui``).

Same INPUT_TYPES schema (nodes.py:168-187, 212-223) and seeded-replication
semantics (nodes.py:232-238) as the JAX package's nodes, the embed core the
port's ``embed_latents`` on ``GSLatent.device`` (the card: K3 makes the
keystream).  The LATENT handed to ComfyUI is float32 on the CPU, as the JAX
node hands it.  Node keys and display names end in ``_torch`` /
``(gswm_torch)``, so the two packs do not collide when both are installed.

Install: copy ``gswm_torch/integrations/comfyui_node`` into
ComfyUI/custom_nodes (it imports NODE_CLASS_MAPPINGS from here).
"""

from __future__ import annotations

import torch

from gswm_torch.config import GSConfig, prepare_message_bytes
from gswm_torch.core.embed import embed_latents
from gswm_torch.eval.registry import KeyRegistry

MAX_RESOLUTION = 8192

_DEFAULT_KEY = "5822ff9cce6772f714192f43863f6bad1bf54b78326973897e6b66c3186b77a7"
_DEFAULT_NONCE = "05072fd1c2265f6f2e2a4080a2bfbdd8"


def gs_watermark_init_noise(
    key_hex, nonce_hex, device, message, use_seed, randomSeed, width, height,
    message_length=-1, u=None,
):
    """Drop-in for nodes.py:51-138: one (4, H/8, W/8) float32 watermarked
    latent on ``device`` plus the info_data.txt side-log.  The uniforms come
    from a generator seeded with ``randomSeed`` when ``use_seed`` is 1,
    fresh entropy otherwise, or ``u`` (1, elements) when given."""
    cfg = GSConfig(
        key_hex=key_hex or "",
        nonce_hex=nonce_hex or "",
        message=str(message) if message else "",
        message_bits=message_length,
        width=width,
        height=height,
        seed=int(randomSeed) if int(use_seed) == 1 else None,
    ).resolved()
    msg = prepare_message_bytes(cfg.message, cfg.message_bytes_len)
    lat, msg = embed_latents(cfg, batch=1, message_bytes=msg, u=u, device=device)

    key, nonce = cfg.resolve_key_nonce()
    KeyRegistry(".").record(key, nonce, msg, seed=randomSeed, height=height,
                            width=width, message_length=message_length)
    return lat[0]


class GSLatent:
    # where the node embeds; ComfyUI gets its LATENT on the CPU either way
    device = "cuda"

    @classmethod
    def INPUT_TYPES(s):
        return {"required": {
            "use_seed": ("INT", {"default": 1, "min": 0, "max": 1}),
            "seed": ("INT", {"default": 42, "min": 0, "max": 0xFFFFFFFF}),
            "width": ("INT", {"default": 512, "min": 64, "max": MAX_RESOLUTION, "step": 8}),
            "height": ("INT", {"default": 512, "min": 64, "max": MAX_RESOLUTION, "step": 8}),
            "key": ("STRING", {"default": _DEFAULT_KEY}),
            "nonce": ("STRING", {"default": _DEFAULT_NONCE}),
            "message": ("STRING", {"default": "lthero"}),
            "message_length": ("INT", {"default": -1, "min": 32, "max": 1024, "step": 32}),
            "batch_size": ("INT", {"default": 1, "min": 1, "max": 64}),
        }}

    RETURN_TYPES = ("LATENT", "IMAGE")
    FUNCTION = "create_gs_latents"
    CATEGORY = "GSWatermark-gswm_torch/latent/noise"

    def create_gs_latents(self, key, nonce, message, batch_size, use_seed,
                          seed, width, height, message_length):
        def one():
            return gs_watermark_init_noise(key, nonce, self.device, message, use_seed,
                                           seed, width, height, message_length)

        if use_seed == 1:
            lats = [one()] * batch_size  # replicate (nodes.py:232-238)
        else:
            lats = [one() for _ in range(batch_size)]
        latent = torch.stack(lats).float().cpu()
        # IMAGE output: a ComfyUI image batch (B, H, W, 3) in [0, 1], a
        # normalized view of the latent's first 3 channels (the reference
        # returns the raw latent here, nodes.py:240, which is no IMAGE)
        vis = latent[:, :3]
        lo = vis.amin(dim=(1, 2, 3), keepdim=True)
        hi = vis.amax(dim=(1, 2, 3), keepdim=True)
        preview = ((vis - lo) / (hi - lo + 1e-8)).permute(0, 2, 3, 1)
        return ({"samples": latent}, preview)


def common_ksampler(model, seed, steps, cfg, sampler_name, scheduler,
                    positive, negative, latent, denoise=1.0,
                    disable_noise=False, start_step=None, last_step=None,
                    force_full_denoise=False, use_GS=False,
                    GS_latent_noise=None):
    """Noise substitution around comfy.sample.sample (nodes.py:141-164):
    when use_GS, the prepared noise IS the watermarked latent."""
    import comfy.sample
    import comfy.utils
    import latent_preview

    latent_image = latent["samples"]
    if use_GS:
        noise = GS_latent_noise["samples"]
    elif disable_noise:
        noise = torch.zeros(latent_image.size(), dtype=latent_image.dtype,
                            layout=latent_image.layout, device="cpu")
    else:
        batch_inds = latent.get("batch_index")
        noise = comfy.sample.prepare_noise(latent_image, seed, batch_inds)

    noise_mask = latent.get("noise_mask")
    callback = latent_preview.prepare_callback(model, steps)
    disable_pbar = not comfy.utils.PROGRESS_BAR_ENABLED
    samples = comfy.sample.sample(
        model, noise, steps, cfg, sampler_name, scheduler, positive, negative,
        latent_image, denoise=denoise, disable_noise=disable_noise,
        start_step=start_step, last_step=last_step,
        force_full_denoise=force_full_denoise, noise_mask=noise_mask,
        callback=callback, disable_pbar=disable_pbar, seed=seed,
    )
    out = latent.copy()
    out["samples"] = samples
    return (out,)


class GSKSamplerAdvanced:
    @classmethod
    def INPUT_TYPES(s):
        import comfy.samplers

        return {"required": {
            "model": ("MODEL",),
            "add_GS_noise": (["enable", "disable"],),
            "add_noise": (["disable", "enable"],),
            "noise_seed": ("INT", {"default": 42, "min": 0, "max": 0xFFFFFFFFFFFFFFFF}),
            "steps": ("INT", {"default": 20, "min": 1, "max": 10000}),
            "cfg": ("FLOAT", {"default": 8.0, "min": 0.0, "max": 100.0,
                              "step": 0.1, "round": 0.01}),
            "sampler_name": (comfy.samplers.KSampler.SAMPLERS,),
            "scheduler": (comfy.samplers.KSampler.SCHEDULERS,),
            "positive": ("CONDITIONING",),
            "negative": ("CONDITIONING",),
            "latent_image": ("LATENT",),
            "GS_latent_noise": ("LATENT",),
            "start_at_step": ("INT", {"default": 0, "min": 0, "max": 10000}),
            "end_at_step": ("INT", {"default": 10000, "min": 0, "max": 10000}),
            "return_with_leftover_noise": (["disable", "enable"],),
        }}

    RETURN_TYPES = ("LATENT",)
    FUNCTION = "sample"
    CATEGORY = "GSWatermark-gswm_torch/sampling"

    def sample(self, model, add_GS_noise, add_noise, noise_seed, steps, cfg,
               sampler_name, scheduler, positive, negative, latent_image,
               GS_latent_noise, start_at_step, end_at_step,
               return_with_leftover_noise, denoise=1.0):
        return common_ksampler(
            model, noise_seed, steps, cfg, sampler_name, scheduler, positive,
            negative, latent_image, denoise=denoise,
            disable_noise=(add_noise == "disable"),
            start_step=start_at_step, last_step=end_at_step,
            force_full_denoise=(return_with_leftover_noise != "enable"),
            use_GS=(add_GS_noise == "enable"), GS_latent_noise=GS_latent_noise,
        )


NODE_CLASS_MAPPINGS = {
    "Gswm_GSLatent_torch": GSLatent,
    "Gswm_GS_KSamplerAdvanced_torch": GSKSamplerAdvanced,
}

NODE_DISPLAY_NAME_MAPPINGS = {
    "Gswm_GSLatent_torch": "GS Latent Noise (gswm_torch)",
    "Gswm_GS_KSamplerAdvanced_torch": "GS KSamplerAdvanced (gswm_torch)",
}
