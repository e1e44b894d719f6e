"""The work a request does, counted on the plain reference at the mix's
shapes on the meta device (nothing is allocated or computed), and the
least time one NVIDIA H100 SXM could do it in.

FLOPs are ``torch.utils.flop_counter.FlopCounterMode``'s count of the
reference's matrix products and convolutions: the same work whatever
implements it. Attention cores are the reference's own log of them
(``reference.model.ATTENTION_LOG``). Peaks and the roofline arithmetic are
NVIDIA's published dense rates at the 700 W limit, copied from the port's
``roofline.py`` (``bound_ms``, ``attention_cost``): 989e12 FLOP/s in bf16,
3.35e12 bytes/s, and attention's exponentials at 16 ``ex2`` a clock an SM,
132 x 16 x 1.83e9 a second.
"""

from __future__ import annotations

import functools
import json

import torch

from h100bench.reference import model

PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
PEAK_EXP2 = 132 * 16 * 1.83e9
BF16 = 2


def bound_ms(ops: float, nbytes: float, peak_ops: float, exps: float = 0) -> tuple[float, str]:
    """(least milliseconds, which roof gives it: "operations",
    "exponentials" or "bytes"); a tie goes to the one named first."""
    times = {"operations": ops / peak_ops, "exponentials": exps / PEAK_EXP2,
             "bytes": nbytes / PEAK_BYTES}
    roof = max(times, key=times.get)
    return 1e3 * times[roof], roof


def attention_cost(b: int, sq: int, sk: int, h: int, d: int, elem: int = BF16):
    """(FLOP, bytes, exponentials) of softmax(q k^T) v: two products of
    2 Sq Sk D a head, q and out of Sq rows and k and v of Sk read or written
    once, one exponential a logit."""
    return (4 * b * h * sq * sk * d, elem * b * h * d * (2 * sq + 2 * sk), b * h * sq * sk)


def attention_bound_s(core: tuple) -> float:
    """Least seconds of one logged core ``(kind, B, Sq, Sk, H, D)`` in bf16."""
    flops, nbytes, exps = attention_cost(*core[1:])
    return bound_ms(flops, nbytes, PEAK_BF16, exps)[0] / 1e3


def _meta_inputs(config: dict, batch: int, res: int):
    f = 2 ** (len(config["vae"]["block_out_channels"]) - 1)
    lat = torch.zeros((batch, config["vae"]["latent_channels"], res // f, res // f),
                      device="meta")
    ctx = torch.zeros((batch, config["text"]["max_length"], config["unet"]["cross_attn_dim"]),
                      device="meta")
    added = None
    if config["unet"].get("addition_embed_dim"):
        added = {"text_embeds": torch.zeros((batch, config["text2"]["hidden_size"]), device="meta"),
                 "time_ids": torch.zeros((batch, 6), device="meta")}
    return lat, ctx, added


def _count(fn) -> tuple[int, list]:
    from torch.utils.flop_counter import FlopCounterMode

    model.ATTENTION_LOG = []
    try:
        with FlopCounterMode(display=False) as counter:
            fn()
        return counter.get_total_flops(), model.ATTENTION_LOG
    finally:
        model.ATTENTION_LOG = None


def unet_forward(config: dict, batch: int, res: int) -> tuple[int, list]:
    """(FLOPs, attention cores) of one UNet forward at ``batch`` latents of a
    ``res`` x ``res`` image."""
    unet = model.build({"unet": config["unet"]})["unet"]
    lat, ctx, added = _meta_inputs(config, batch, res)
    return _count(lambda: unet(lat, torch.zeros((), device="meta"), ctx, added))


@functools.lru_cache(maxsize=8)
def _request(config_json: str, mix_json: str) -> tuple[int, tuple]:
    config, mix = json.loads(config_json), json.loads(mix_json)
    b, res, steps = mix["batch"], mix["resolution"], mix["steps"]
    parts = model.build(config)
    vae = parts["vae"]
    guided = mix["entry"] == "generate" and mix["guidance"] not in (None, 1.0)
    flops, cores = unet_forward(config, 2 * b if guided else b, res)
    flops, cores = steps * flops, steps * cores
    if mix["entry"] == "extract":
        f, c = _count(lambda: vae.encode(torch.zeros((b, 3, res, res), device="meta")))
    elif mix["entry"] == "generate":
        lat, _, _ = _meta_inputs(config, b, res)
        ids = torch.zeros((b, config["text"]["max_length"]), dtype=torch.long, device="meta")

        def rest():
            parts["text"](ids)
            if "text2" in parts:
                parts["text2"](ids)
            vae.decode(lat)

        f, c = _count(rest)
    else:
        raise ValueError(f"entry {mix['entry']!r}")
    return flops + f, tuple(cores + c)


def request(config: dict, mix: dict) -> tuple[int, list]:
    """(model FLOPs, attention cores) of one request of ``mix``: the text
    encoders on the prompt (the empty prompt's are the pipeline's once), the
    30 UNet forwards (at twice the batch under guidance), the VAE encoder or
    decoder."""
    flops, cores = _request(json.dumps(config, sort_keys=True), json.dumps(mix, sort_keys=True))
    return flops, list(cores)
