"""The system under test: gswm_torch's ``InversablePipeline`` on the
benchmark's weights, and the one request of each traffic entry.

Nothing of the program is imported at module level, so that the reference
and the tests can import this package where the program is absent.
"""

from __future__ import annotations

import torch

# the program's modules the benchmark names its ranges and hooks after
RANGES = ("unet", "vae.encoder", "vae.decoder", "text", "text2")


def preset(config: dict):
    """The configuration file as the program's ``ModelPreset``."""
    from gswm_torch.models.configs import ModelPreset, TextConfig, UNetConfig, VAEConfig

    def tup(d: dict) -> dict:
        return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}

    return ModelPreset(
        name=config["name"], unet=UNetConfig(**tup(config["unet"])),
        vae=VAEConfig(**tup(config["vae"])), text=TextConfig(**config["text"]),
        text2=TextConfig(**config["text2"]) if config.get("text2") else None,
        prediction_type=config["prediction_type"],
        default_resolution=config["default_resolution"])


def build(config: dict, states: dict, device):
    """The program's pipeline, its parameters taken from ``states`` through
    ``models.loader.load_state_``; the UNet and VAE in the configuration's
    dtype with their norms kept float32, the text encoders float32."""
    from gswm_torch.models import loader
    from gswm_torch.models.layers import to_compute_dtype_
    from gswm_torch.pipelines.inversable import InversablePipeline

    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[config["dtype"]]
    pipe = InversablePipeline(preset(config), device="meta", dtype=dtype)
    device = torch.device(device)
    for name in ("unet", "vae", "text", "text2"):
        if name not in states:
            continue
        module = loader.load_state_(getattr(pipe, name), states[name], name)
        if name in ("unet", "vae"):
            to_compute_dtype_(module, device, dtype)
        else:
            module.to(device)
    pipe.device = device
    proj = states.get("text2_projection")
    pipe.text2_projection = None if proj is None else proj.to(device, torch.float32)
    pipe.reset_caches()
    return pipe


def gs_config(config: dict, mix: dict, requests):
    from gswm_torch.config import GSConfig

    f = 2 ** (len(config["vae"]["block_out_channels"]) - 1)
    return GSConfig(key_hex=requests.key.hex(), nonce_hex=requests.nonce.hex(),
                    message_bits=mix["message_bits"], width=mix["resolution"],
                    height=mix["resolution"], vae_scale=f,
                    channels=config["vae"]["latent_channels"])


class Capture:
    """Forward hooks that keep what the timed path makes and the check
    reads: the VAE posterior mean (``latents``, extraction), the first UNet
    call's conditioning of a request (``context``, ``text_embeds``) and the
    latents the decoder is handed (``final``, generation). Each list holds
    one entry a request, on the device; the hooks copy nothing."""

    def __init__(self, pipe, config: dict):
        self.scale = config["vae"]["scaling_factor"]
        self.lc = config["vae"]["latent_channels"]
        self.latents, self.context, self.text_embeds, self.final = [], [], [], []
        self._first_unet = False
        self._parts = []
        self.handles = [
            pipe.vae.quant_conv.register_forward_hook(self._moments),
            pipe.unet.register_forward_pre_hook(self._unet),
            pipe.vae.post_quant_conv.register_forward_pre_hook(self._decoded),
        ]

    def begin(self) -> None:
        self._first_unet = True
        self._parts = []

    def end(self) -> None:
        if self._parts:
            self.latents.append(torch.cat(self._parts))

    def _moments(self, module, args, out):
        self._parts.append(out[:, : self.lc])

    def _unet(self, module, args):
        if self._first_unet:
            self._first_unet = False
            _, _, ctx, added = (tuple(args) + (None,) * 4)[:4]
            self.context.append(ctx)
            self.text_embeds.append(None if added is None else added["text_embeds"])

    def _decoded(self, module, args):
        self.final.append(args[0])

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


class Ranges:
    """``torch.profiler.record_function`` ranges around the program's
    modules of ``RANGES``, opened and closed by forward hooks."""

    def __init__(self, pipe):
        self.handles = []
        for name in RANGES:
            module = pipe
            for part in name.split("."):
                module = getattr(module, part, None)
            if module is None:
                continue
            stack = []

            def enter(m, args, _name=name, _stack=stack):
                rf = torch.autograd.profiler.record_function(_name)
                rf.__enter__()
                _stack.append(rf)

            def leave(m, args, out, _stack=stack):
                _stack.pop().__exit__(None, None, None)

            self.handles += [module.register_forward_pre_hook(enter),
                             module.register_forward_hook(leave)]

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


class Entry:
    """One request of the mix's entry, driven as a user drives it, ending when
    its answer is on the host: ``extract`` returns the voted bits (and keeps
    z_T for the check), ``generate`` the images (and keeps z_T)."""

    def __init__(self, pipe, config: dict, mix: dict, requests):
        self.pipe, self.mix, self.requests = pipe, mix, requests
        self.cfg = gs_config(config, mix, requests)
        self.answers, self.z_T = [], []

    def __call__(self, r: int):
        if self.mix["entry"] == "extract":
            return self._extract(r)
        if self.mix["entry"] == "generate":
            return self._generate(r)
        raise ValueError(f"entry {self.mix['entry']!r}")

    def _extract(self, r: int):
        images = self.requests.images(r)
        bits, z = self.pipe.extract_bits(self.cfg, images=images, num_steps=self.mix["steps"],
                                         scheduler=self.mix["scheduler"])
        self.z_T.append(z)
        self.answers.append(bits.cpu())

    def _generate(self, r: int):
        from gswm_torch.core.embed import embed_latents

        z, _ = embed_latents(self.cfg, batch=self.mix["batch"], u=self.requests.uniforms(r),
                             message_bytes=self.requests.message, replicate=False,
                             device=self.pipe.device)
        images = self.pipe.generate(z, prompt_ids=self.requests.prompt(r),
                                    guidance_scale=self.mix["guidance"],
                                    num_steps=self.mix["steps"], scheduler=self.mix["scheduler"])
        self.z_T.append(z)
        self.answers.append(images.cpu())
