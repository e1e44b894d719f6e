"""What decides ``correct``: the timed path's own outputs against the plain
reference (``reference/``), which takes the same weights and inputs and
works out everything else again, in float32 with TF32 off.

Extraction (``extract``): the voted bits of every image of the window are
held exactly against the reference's ChaCha20 decryption and vote of the
program's own z_T (``bits_wrong``, limit 0); a sample of images drawn from
the seed, one from each half of a batch, is run through the reference's
whole chain from its pixels, and the program's VAE posterior mean
(``latents_rel``) and recovered z_T (``zT_rel``) are held to it.

Generation (``generate``): the embedded z_T of every request is held to the
reference's embed (``zT_gap``); a sampled request is run through the
reference's chain, and the program's text conditioning (``context_rel``,
both encoders, prompt and empty prompt; ``pooled_rel``, SDXL's pooled
text), the latents it hands the decoder (``latents_rel``) and its decoded
image (``image_rel``) are held to it.

A ``*_rel`` number is the worst over the sample of ||program - reference||
/ ||reference||, each image or request apart; a ``*_gap`` the largest
absolute difference; each has its limit in ``limits/<cell>.json``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from h100bench import inputs
from h100bench.reference import chacha
from h100bench.reference.pipeline import Reference, control_precision


def sample(mix: dict, finished: int, seed: int) -> list:
    """[(request, rows)]: ``check.requests`` of the finished requests, drawn
    from the seed, and in each ``check.rows`` rows: the first from the
    batch's first half, the second from its second half, any more from the
    rest."""
    rng = np.random.default_rng(inputs.derive(seed, "check"))
    n = min(mix["check"]["requests"], finished)
    chosen = sorted(rng.choice(finished, size=n, replace=False).tolist())
    b, k = mix["batch"], min(mix["check"]["rows"], mix["batch"])
    out = []
    for r in chosen:
        if b == 1:
            out.append((r, [0]))
            continue
        rows = [int(rng.integers(0, b // 2)), int(rng.integers(b // 2, b))][:k]
        rest = [x for x in range(b) if x not in rows]
        rows += rng.choice(rest, size=k - len(rows), replace=False).tolist()
        out.append((r, sorted(rows)))
    return out


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """Worst over the leading axis of ||a - b|| / ||b||."""
    a, b = a.double().flatten(1), b.double().flatten(1).to(a.device)
    return float(((a - b).norm(dim=1) / b.norm(dim=1).clamp(min=1e-30)).max())


def reference_out(ref: Reference, mix: dict, requests, picks: list) -> dict:
    """The reference's outputs for the sampled rows, stacked in pick order."""
    steps = mix["steps"]
    if mix["entry"] == "extract":
        images = torch.cat([requests.images(r)[rows] for r, rows in picks])
        outs = [ref.extract(images[i:i + mix["check"]["chunk"]], steps)
                for i in range(0, images.shape[0], mix["check"]["chunk"])]
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    cipher = cipher_bits(requests)
    outs = [ref.generate(requests.uniforms(r)[rows], cipher, requests.prompt(r)[rows], steps,
                         mix["guidance"], mix["resolution"]) for r, rows in picks]
    return {k: None if outs[0][k] is None else torch.cat([o[k] for o in outs]) for k in outs[0]}


def program_out(captured: dict, config: dict, mix: dict, picks: list) -> dict:
    """The program's outputs for the same rows, as the timed path left them."""
    scale = config["vae"]["scaling_factor"]

    def rows_of(seq):
        return torch.cat([seq[r][rows] for r, rows in picks])

    if mix["entry"] == "extract":
        return {"latents": rows_of(captured["latents"]).float() * scale,
                "z_T": rows_of(captured["z_T"]).float()}
    b = mix["batch"]
    # the UNet's conditioning rows of a request: its empty prompt's, then its prompt's
    ctx = torch.cat([torch.cat([captured["context"][r][rows],
                                captured["context"][r][[b + x for x in rows]]])
                     for r, rows in picks]).float()
    te = captured["text_embeds"]
    return {"z_T": rows_of(captured["z_T"]).float(), "context": ctx,
            "text_embeds": None if te[0] is None else rows_of(te).float(),
            "latents": rows_of(captured["final"]).float() * scale,
            "images": rows_of(captured["answers"]).float()}


def compare(entry: str, cand: dict, ref: dict) -> dict:
    """The sampled numbers of ``cand`` (the program's or the control's
    outputs) against the reference's."""
    if entry == "extract":
        return {"latents_rel": _rel(cand["latents"], ref["latents"]),
                "zT_rel": _rel(cand["z_T"], ref["z_T"])}
    b = ref["z_T"].shape[0]
    # context rows come as (empty, prompt) a request; compare as one block a request
    out = {"context_rel": _rel(cand["context"].reshape(b, -1), ref["context"].reshape(b, -1)),
           "latents_rel": _rel(cand["latents"], ref["latents"]),
           "image_rel": _rel(cand["images"], ref["images"])}
    if ref["text_embeds"] is not None:
        out["pooled_rel"] = _rel(cand["text_embeds"], ref["text_embeds"])
    return out


def cipher_bits(requests) -> torch.Tensor:
    n = int(np.prod(requests.latent_shape))
    return (chacha.payload_bits(requests.message, n, requests.device)
            ^ chacha.keystream_bits(requests.key, requests.nonce, n, requests.device))


def window_numbers(captured: dict, mix: dict, requests) -> dict:
    """The numbers taken over every answer of the window."""
    n = int(np.prod(requests.latent_shape))
    if mix["entry"] == "extract":
        ks = chacha.keystream_bits(requests.key, requests.nonce, n, requests.device)
        wrong = 0
        for z, bits in zip(captured["z_T"], captured["answers"]):
            want = chacha.extract(z, ks, 1, mix["message_bits"])
            wrong += int((bits.to(want.device) != want).sum())
        return {"bits_wrong": float(wrong)}
    cipher = cipher_bits(requests)
    gap = 0.0
    for r, z in enumerate(captured["z_T"]):
        want = chacha.embed(requests.uniforms(r), cipher, 1, requests.latent_shape)
        gap = max(gap, float((z.double() - want.to(z.device)).abs().max()))
    return {"zT_gap": gap}


def judge(cell, seed: int, device, captured: dict, finished: int, requests,
          control: bool = False):
    """The numbers of a run whose program has been freed: those over the
    whole window, then the sampled ones against the reference, which is
    built from the seed's weights anew. With ``control`` also, second, the
    sampled numbers of the reference one precision below
    (``control_precision``) put in the program's place, on the same sample."""
    picks = sample(cell.mix, finished, seed)
    states = inputs.make_states(cell.config, seed, device)
    ref_out = reference_out(Reference(cell.config, states, device), cell.mix, requests, picks)
    numbers = window_numbers(captured, cell.mix, requests)
    numbers.update(compare(cell.mix["entry"],
                           program_out(captured, cell.config, cell.mix, picks), ref_out))
    if not control:
        return numbers
    low = reference_out(Reference(cell.config, states, device, control_precision(cell.config)),
                        cell.mix, requests, picks)
    lows = compare(cell.mix["entry"], low, ref_out)
    if cell.mix["entry"] == "generate":
        lows["zT_gap"] = float((low["z_T"].double() - ref_out["z_T"].double()).abs().max())
    return numbers, lows


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, none missing, none NaN."""
    checks, ok = {}, True
    for name, spec in limits.items():
        value = numbers.get(name)
        if value is None:
            continue
        checks[name] = {"value": value, "limit": spec["limit"]}
        ok &= not math.isnan(value) and value <= spec["limit"]
    missing = set(numbers) - set(checks)
    if missing:
        raise KeyError(f"no limit for {sorted(missing)}")
    return ok, checks
