"""The reference's two chains, on the benchmark's weights and inputs.

``extract``: images -> VAE posterior mean -> 30-step DDIM inversion on the
empty prompt at guidance 1 -> z_T (the watermark's bits are read from it by
``chacha.extract``). ``generate``: uniforms and cipher bits -> the embedded
z_T -> both prompts through the text encoders -> guided DDIM -> VAE decode.
SDXL conditions on both encoders' contexts, concatenated, and on the second
encoder's pooled output of the empty prompt with time ids (h, w, 0, 0, h, w),
as the measured pipeline does.
"""

from __future__ import annotations

import torch

from h100bench.reference import chacha, ddim, model
from h100bench.reference.precision import FP32, Precision, exact_float32, set_precision

PARTS = ("unet", "vae", "text", "text2")


class Reference:
    """The configuration's modules in float32 on ``device``, their weights
    the benchmark's ``states`` (any floating dtype; taken as float32).
    ``precision`` maps a part (``unet``, ``vae``, ``text``, ``embed``) to
    the precision of its products; float32 where it names none."""

    def __init__(self, config: dict, states: dict, device, precision: dict | None = None):
        self.config = config
        self.device = torch.device(device)
        self.modules = model.build(config, "meta")
        for name, module in self.modules.items():
            state = {k: v.to(self.device, torch.float32) for k, v in states[name].items()}
            module.load_state_dict(state, strict=True, assign=True)
        proj = states.get("text2_projection")
        self.projection = None if proj is None else proj.to(self.device, torch.float32)
        precision = precision or {}
        for name, module in self.modules.items():
            set_precision(module, precision.get(name.rstrip("2"), FP32))
        self.embed_precision = precision.get("embed", FP32)

    def encode_prompt(self, ids) -> torch.Tensor:
        text, text2 = self.modules["text"], self.modules.get("text2")
        h = text(ids)
        return h if text2 is None else torch.cat([h, text2(ids)], dim=-1)

    def added_cond(self, batch: int, height: int, width: int):
        """SDXL's micro-conditioning of the empty prompt, None elsewhere."""
        if "text2" not in self.modules:
            return None
        enc = self.modules["text2"]
        pooled = enc.pooled(enc.empty_prompt_ids(1), self.projection)
        tid = torch.tensor([[height, width, 0, 0, height, width]], dtype=torch.float32,
                           device=self.device)
        return {"text_embeds": pooled.expand(batch, -1), "time_ids": tid.expand(batch, 6)}

    @torch.inference_mode()
    def extract(self, images: torch.Tensor, steps: int) -> dict:
        """images (B, 3, H, W) in [0, 1] -> {latents, z_T}, float32."""
        with exact_float32():
            images = images.to(self.device)
            lat = self.modules["vae"].encode(images)
            b = lat.shape[0]
            ctx = self.encode_prompt(self.modules["text"].empty_prompt_ids(1)).expand(b, -1, -1)
            added = self.added_cond(b, images.shape[-2], images.shape[-1])
            z = ddim.run(self.modules["unet"], lat, ctx, self.config["scheduler"], steps,
                         invert=True, added=added,
                         prediction=self.config["prediction_type"])
        return {"latents": lat, "z_T": z}

    @torch.inference_mode()
    def generate(self, u: torch.Tensor, cipher: torch.Tensor, ids, steps: int,
                 guidance: float, resolution: int) -> dict:
        """Uniforms (B, elements) and cipher bits -> {z_T, context (the
        unconditional rows, then the prompt's), text_embeds, latents, images}."""
        lc = self.config["vae"]["latent_channels"]
        f = 2 ** (len(self.config["vae"]["block_out_channels"]) - 1)
        shape = (lc, resolution // f, resolution // f)
        with exact_float32():
            z = self.embed_precision(chacha.embed(u.to(self.device), cipher.to(self.device),
                                                  1, shape).float())
            b = z.shape[0]
            cond = self.encode_prompt(ids)
            uncond = self.encode_prompt(self.modules["text"].empty_prompt_ids(1)).expand(b, -1, -1)
            added = self.added_cond(b, resolution, resolution)
            lat = ddim.run(self.modules["unet"], z, cond, self.config["scheduler"], steps,
                           invert=False, added=added, uncond=uncond, guidance=guidance,
                           prediction=self.config["prediction_type"])
            images = self.modules["vae"].decode(lat)
        return {"z_T": z, "context": torch.cat([uncond, cond]),
                "text_embeds": None if added is None else added["text_embeds"],
                "latents": lat, "images": images}


def control_precision(config: dict) -> dict:
    """One precision below each part's stated one: fp8 under a bfloat16 UNet
    and VAE, TF32 under float32 text encoders, bfloat16 under the float32
    embed."""
    below = {"bfloat16": "fp8", "float32": "tf32"}
    return {"unet": Precision(below[config["dtype"]]), "vae": Precision(below[config["dtype"]]),
            "text": Precision(below[config["text_dtype"]]), "embed": Precision("bf16")}
