"""Everything a run feeds the program, made from ``--seed``: the weights, the
watermark's key, nonce and message, and each request's images, uniforms and
prompt. The same seed gives the same inputs, and every seed the same sizes.

Weights are diffusers-layout state dicts, named and shaped as the plain
reference's modules are (``reference.model``), made on the device in the
dtype each part is served in, a few large draws a module: matrices and
kernels a normal truncated at two standard deviations with variance
1/fan_in (flax's lecun-normal, the port's own random init), norm scales
1 + 0.02 n and biases 0.02 n, so a dropped bias or scale shows.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from h100bench.reference import model

TRUNC_NORMAL_STD = 0.87962566103423978  # of N(0, 1) truncated to [-2, 2]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def derive(seed: int, *what) -> int:
    """A 63-bit seed of its own for each use of the run's ``seed``."""
    h = hashlib.sha256(repr((int(seed),) + what).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(device, seed: int, *what) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *what))


def _fill(shapes: dict, dtype, device, gen) -> dict:
    """{name: shape} -> {name: tensor}, every tensor a view of one buffer
    drawn in two calls."""
    total = sum(int(np.prod(s)) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    flat.clamp_(-2.0, 2.0)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        t = flat[at:at + n].view(shape)
        at += n
        if len(shape) >= 2:
            t.mul_(float(np.prod(shape[1:])) ** -0.5 / TRUNC_NORMAL_STD)
        elif name.endswith("weight"):
            t.mul_(0.02).add_(1.0)
        else:
            t.mul_(0.02)
        out[name] = t
    return out


def make_states(config: dict, seed: int, device) -> dict:
    """The weights of every part: ``unet`` and ``vae`` in the configuration's
    dtype, the text encoders in its text dtype; for a second text encoder
    also ``text2_projection``, the (in, out) projection of its pooled output."""
    states = {}
    for name, module in model.build(config, "meta").items():
        dtype = DTYPES[config["dtype"] if name in ("unet", "vae") else config["text_dtype"]]
        shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        if name == "text2":
            width = config["text2"]["hidden_size"]
            shapes["text2_projection"] = (width, width)
        states[name] = _fill(shapes, dtype, device, generator(device, seed, "weights", name))
    if "text2" in states:
        states["text2_projection"] = states["text2"].pop("text2_projection")
    return states


class Requests:
    """The mix's requests, each from a seed of its own: ``images(r)`` for
    extraction; ``uniforms(r)`` and ``prompt(r)`` for generation."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.config, self.mix, self.seed, self.device = config, mix, seed, torch.device(device)
        res = mix["resolution"]
        f = 2 ** (len(config["vae"]["block_out_channels"]) - 1)
        self.latent_shape = (config["vae"]["latent_channels"], res // f, res // f)
        rng = np.random.default_rng(derive(seed, "watermark"))
        self.key = rng.bytes(32)
        self.nonce = rng.bytes(16)
        self.message = rng.bytes(mix["message_bits"] // 8)

    def images(self, r: int) -> torch.Tensor:
        """(batch, 3, H, W) float32 images in [0, 1), made on the device."""
        res = self.mix["resolution"]
        return torch.rand((self.mix["batch"], 3, res, res), device=self.device,
                          generator=generator(self.device, self.seed, "images", r))

    def uniforms(self, r: int) -> torch.Tensor:
        """(batch, latent elements) float32 uniforms of the embed."""
        n = int(np.prod(self.latent_shape))
        return torch.rand((self.mix["batch"], n), device=self.device,
                          generator=generator(self.device, self.seed, "uniforms", r))

    def prompt(self, r: int) -> np.ndarray:
        """(batch, 77) token ids: BOS, the mix's ``prompt_tokens`` ids drawn
        from the vocabulary's words, EOS, EOS padding."""
        text = self.config["text"]
        bos, eos = min(model.BOS_ID, text["vocab_size"] - 2), min(model.EOS_ID, text["vocab_size"] - 1)
        n = self.mix["prompt_tokens"]
        ids = np.full((self.mix["batch"], text["max_length"]), eos, dtype=np.int64)
        ids[:, 0] = bos
        rng = np.random.default_rng(derive(self.seed, "prompt", r))
        ids[:, 1:1 + n] = rng.integers(0, bos, size=(self.mix["batch"], n))
        return ids
