"""The paths and kernel shapes that ``chip_smoke.py`` drives and that the
measurement scripts here time and profile: one definition, so a profile is
of the smoke's chain and a kernel comparison is at the smoke's shapes.

Three paths; the first two with random weights from a seed, bf16, on one card:

  * sd-2-1-base at 512x512, batch 4: the extraction chain (embed + VAE
    encode + 30-step inversion + decode) on random images;
  * sd-2-1 (v-prediction) at 768x768, batch 2: the watermark chain (embed ->
    seeded prompt ids -> 30-step DDIM at guidance 7.5 -> VAE decode, then
    ``pipe.extract_bits``: VAE encode -> 30-step inversion -> decode);
  * per-user keys at the JAX package's config-5 scale (record shape in
    benchmarks/config5_multikey_trace.jsonl): 10,000 (key, nonce, message)
    records from a numpy seed at the 512x512 geometry (4x64x64 latents, l = 1,
    256 message bits, 16,384 capacity bits), every record embedded and
    decoded under its own key, 16 probes traced against the whole registry.

A fourth path, on the 768x768 pipeline again, is the robustness bench: each
batched attack at relative strength 0.5 on (2, 3, 768, 768) images from a
seed, held against the same function on the CPU with the same draws; a short
sweep (``eval.sweep.run_sweep``, every attack of ``DEFAULT_ATTACKS`` at 0.5:
17 rows, each one attack, one VAE encode and one 30-step inversion, the
``reversed`` row an inversion and a regeneration more); and the Tree-Ring loop
on latents.

A fifth path is SDXL: sdxl-base at 1024x1024, batch 2, bf16, random weights
from a seed: the latent closed loop and the watermark chain of the 768x768
path (both text encoders, the pooled conditioning and ``time_ids`` in
``added_cond``).

A sixth path is SD 1.x: sd-1-4 at 512x512, batch 4, bf16, random weights from
a seed, 8 heads of 40, 80 and 160: the latent closed loop, and the watermark
chain (CLIP-L, guidance 7.5 at UNet batch 8, decode, then ``extract_bits``).

A seventh is the VAE fit (``FIT_*``): sd-2-1-base's VAE from a seed, two
stages of ``tools/fit_vae.py`` cut to a time share; and an eighth the
command-line path (``CLI_*``): four keys through gs-embed-torch, their
images generated as one batch at 512x512 and read back by gs-extract-torch
and gs-trace-torch, on the fitted VAE.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

KEY_HEX = "22" * 32
NONCE_HEX = "33" * 16
STEPS = 30
# the closed loop under each attention switch set: a shorter loop, five times
TIER_LOOP_STEPS = 10
BATCH_512, RES_512 = 4, 512
BATCH_768, RES_768 = 2, 768
BATCH_1024, RES_1024 = 2, 1024
BATCH_SD14 = 4  # at RES_512
# seeds of the random weights
PIPELINE_SEEDS = {"sd-2-1-base": 0, "sd-2-1": 1, "sdxl-base": 2, "sd-1-4": 3}

# Kernel shapes of the paths.  Batch 4 is the UNet's under guidance and
# in the 512x512 path, batch 2 without; SD 1.x's 4, and 8 under guidance.
# K1 (B, S, C, H, D): UNet levels 1 and 2 at 512x512 (1024, 256 tokens) and
# 768x768 (2304, 576 tokens); SDXL's level 2 and mid block at 1024x1024
# (1024 tokens, 1280 channels, 20 heads); SD 1.x's levels 1 and 2 at 512x512
# (8 heads of 80 and of 160)
K1_SHAPES = ((2, 1024, 640, 10, 64), (2, 256, 1280, 20, 64),
             (4, 2304, 640, 10, 64), (4, 576, 1280, 20, 64),
             (2, 1024, 1280, 20, 64), (4, 1024, 1280, 20, 64),
             (4, 1024, 640, 8, 80), (8, 1024, 640, 8, 80),
             (4, 256, 1280, 8, 160), (8, 256, 1280, 8, 160))
# K2 (B, S, H, D): UNet level 0 at 512x512 (4096 tokens) and 768x768 (9216);
# SDXL's level 1 at 1024x1024 (4096 tokens, 10 heads); SD 1.x's level 0 at
# 512x512 (8 heads of 40) and a ragged shape of that width; the other widths
# of flash_hopper.cu's narrow kernel (d <= 48: one, two and three k16 steps),
# and 56, the first width its d <= 64 kernel keeps
K2_SHAPES = ((2, 4096, 5, 64), (2, 9216, 5, 64), (4, 9216, 5, 64), (2, 4096, 10, 64),
             (4, 4096, 10, 64), (4, 4096, 8, 40), (8, 4096, 8, 40), (1, 1001, 3, 40),
             (4, 4096, 8, 8), (4, 4096, 8, 24), (4, 4096, 8, 48), (4, 4096, 8, 56))
# K4 (B, S, H, D): the VAE mid attention at 768x768 (one head, D = 512, 9216
# tokens; the decoder takes one image a call, the encoder two), a ragged
# multi-head D = 64 shape, two ragged multi-head shapes of the widths
# between: D = 128, and 192 whose three 64-column panels split 2 + 1; the
# VAE mid attention at 1024x1024 (16,384 tokens); SD 1.x's level 1 under
# GSWM_FUSED_QKV=0 (8 heads of 80), a ragged 160 (the 192-wide kernel, its
# third panel half zeros) and a width no SD model uses, 72
K4_SHAPES = ((1, 9216, 1, 512), (2, 9216, 1, 512), (2, 1000, 10, 64),
             (2, 1000, 3, 128), (1, 1000, 2, 192),
             (1, 16384, 1, 512), (2, 16384, 1, 512),
             (4, 1024, 8, 80), (1, 1000, 2, 160), (2, 1000, 3, 72))
# K3 (ChaCha20 blocks of one key): one 64x64x4, 96x96x4 and 128x128x4
# latent of bits (512x512, 768x768, 1024x1024), and 2^20 blocks
K3_BLOCKS = (32, 72, 128, 2**20)
# K6 and K7 (B, S, H): UNet level 0 under their switches, at 768x768 (batch
# 2, and 4 under guidance) and 512x512, and a ragged shape
LEVEL0_SHAPES = ((2, 9216, 5), (4, 9216, 5), (2, 4096, 5), (1, 1000, 3))
# K7 (B, S, H, D): those at D = 64; SD 1.x's level 0 at 512x512 under switch
# set (c) (8 heads of 40, batch 4 and 8 under guidance) and its levels 1 and
# 2's widths (80: 64 + 16 rows, 160: 2 + 1 panels), a width no SD model
# uses (72) and the widest (512: 4 + 4 panels); where S is no multiple of 8
# (rows not 16-byte aligned) the masked kernel, at 64, 40 and 160
K7_SHAPES = (*((b, s, h, 64) for b, s, h in LEVEL0_SHAPES), (1, 1001, 3, 64),
             (4, 4096, 8, 40), (8, 4096, 8, 40), (4, 1024, 8, 80), (4, 256, 8, 160),
             (2, 1000, 3, 72), (1, 1024, 1, 512), (1, 1001, 3, 40), (1, 1001, 2, 160))

# K3 over a key table (rows, ChaCha20 blocks a row): 32 blocks are the 16,384
# bits of a 512x512 latent; 4 rows are phase 7d's batch, 4096 one chunk of the
# trace search, 10,000 the whole registry
K3_BATCH_SHAPES = ((4, 32), (4096, 32), (10000, 32))
# per-user keys (config 5): the registry, the probes traced against it, the
# records the host loop also scores, the images sent through the model, and
# the rows embedded or decoded a call (164 MB of fp32 latents)
MULTIKEY_RECORDS = 10000
MULTIKEY_PROBES = 16
MULTIKEY_HOST_SLICE = 256
MULTIKEY_MODEL_BATCH = 4
MULTIKEY_ROWS_PER_CALL = 2500
MULTIKEY_SEED = 505

# phase 12 (multi-device on one card): K4 with its log-sum-exp output at the
# ring's full-width shapes (B, S, H, D): sd-2-1 768x768 level 0, SDXL level
# 1, SD 1.x level 0 (the narrow kernel), SD 1.x level 1's width, the SDXL
# VAE's mid attention; each also as a query shard against a key shard of
# S / LSE_SHARDS; and the ring's sizes on one card
LSE_SHAPES = ((2, 9216, 5, 64), (2, 4096, 10, 64), (4, 4096, 8, 40), (4, 1024, 8, 80),
              (1, 16384, 1, 512))
LSE_SHARDS = 4
RING_SP = (2, 4)
# phase 12c/d: sd-2-1-base's UNet at 512x512, batch 2 (the tp forward), and
# the dp leg's extraction of 4 watermarked latents
MULTIDEVICE_UNET_BATCH = 2
MULTIDEVICE_DP_BATCH = 4
MULTIDEVICE_SEED = 1313

# K8 (NCHW shape, activation): the largest GroupNorm of the 768x768 path (VAE)
# and the UNet's level-0 one, the two whose times the records quote
K8_PROBE_CASES = (((1, 128, 768, 768), "silu"), ((2, 320, 96, 96), "silu"))

# The JAX package's switch sets that move the UNet's level-0 and level-1/2
# self-attention off the default route: (a) cres -> K2, (b) packed K6, (c)
# transposed K7, (d) seqhead -> K1, (e) no fused qkv -> K4 at level 1
TIER_SWITCHES = {
    "a": {"GSWM_XF_ATTN": "0"},
    "b": {"GSWM_XF_ATTN": "0", "GSWM_CRES_ATTN": "0", "GSWM_PACKED_ATTN": "1"},
    "c": {"GSWM_XF_ATTN": "0", "GSWM_CRES_ATTN": "0", "GSWM_TRANSPOSED_ATTN": "1"},
    "d": {"GSWM_FUSED_QKV_MODE": "seqhead"},
    "e": {"GSWM_FUSED_QKV": "0"},
}


@contextlib.contextmanager
def route_switches(switches: dict):
    """The attention route's switches set to ``switches`` alone; the
    environment restored afterwards."""
    from gswm_torch.ops.attention import ROUTE_SWITCHES

    saved = {name: os.environ.pop(name) for name in ROUTE_SWITCHES if name in os.environ}
    os.environ.update(switches)
    try:
        yield
    finally:
        for name in ROUTE_SWITCHES:
            os.environ.pop(name, None)
        os.environ.update(saved)


def pairs_of(heads: int) -> int:
    """Head pairs of the pair-packed layout: the last half pair of an odd
    head count is a zero pad head."""
    return -(-heads // 2)


def config(res: int, message: str):
    from gswm_torch import GSConfig

    return GSConfig(key_hex=KEY_HEX, nonce_hex=NONCE_HEX, message=message,
                    width=res, height=res, message_bits=256)


def build_pipeline(preset: str, dev="cuda"):
    from gswm_torch.pipelines import InversablePipeline

    return InversablePipeline(
        preset, device=dev, dtype=torch.bfloat16,
        generator=torch.Generator(device=dev).manual_seed(PIPELINE_SEEDS[preset]))


def embed(cfg, batch: int, seed: int, dev="cuda"):
    """(watermarked z_T, message bytes) from a seeded generator."""
    from gswm_torch import embed_latents

    return embed_latents(cfg, generator=torch.Generator(device=dev).manual_seed(seed),
                         batch=batch, device=dev)


def prompt_ids(pipe, batch: int, seed: int = 2024) -> np.ndarray:
    """Seeded (B, 77) token ids: a prompt of random words."""
    return np.random.default_rng(seed).integers(
        0, pipe.preset.text.vocab_size - 2, (batch, pipe.preset.text.max_length))


def unet_inputs(pipe, batch: int, dev="cuda", res: int = RES_768):
    """Seeded latents (B, 4, res/8, res/8), timestep 500 and a seeded
    prompt's context: one UNet input at res x res; and SDXL's added_cond."""
    g = torch.Generator(device=dev).manual_seed(77)
    lat = torch.randn((batch, 4, res // 8, res // 8), generator=g, device=dev)
    inputs = (lat, torch.full((batch,), 500, device=dev),
              pipe.encode_prompt_ids(prompt_ids(pipe, batch, seed=7)))
    added = pipe.default_added_cond(batch, res, res)
    return inputs if added is None else (*inputs, added)


def generate_watermarked(pipe, cfg, ids, seed: int, batch: int = BATCH_768):
    """First half of the watermark chain: embed, then guided generation (the
    prompt ids through every text encoder; UNet batch 2 x ``batch``) and VAE
    decode.  Returns (images, message bytes)."""
    zt, msg = embed(cfg, batch, seed)
    images = pipe.generate(zt, prompt_ids=ids, guidance_scale=7.5, num_steps=STEPS)
    return images, msg


def watermark_chain(pipe, cfg, ids, seed: int, batch: int = BATCH_768):
    """The whole watermark chain.  Returns (images, message bytes, bits, z_T)."""
    images, msg = generate_watermarked(pipe, cfg, ids, seed, batch)
    bits, z_t = pipe.extract_bits(cfg, images=images, num_steps=STEPS)
    return images, msg, bits, z_t


def random_images_512(dev="cuda") -> torch.Tensor:
    return torch.rand((BATCH_512, 3, RES_512, RES_512),
                      generator=torch.Generator(device=dev).manual_seed(99), device=dev)


def extraction_chain_512(pipe, cfg, images, seed: int):
    """Embed + VAE encode + 30-step inversion + decode.  Returns (bits,
    recovered z_T, embedded z_T)."""
    from gswm_torch import recover_message_bits

    zt, _ = embed(cfg, BATCH_512, seed)
    z = pipe.invert(latents=pipe.image_to_latents(images), num_steps=STEPS)
    return recover_message_bits(z, cfg), z, zt


def groupnorm_act(name: str):
    """The activation after a GroupNorm: SiLU after every ResnetBlock norm
    and the final norms (layers.py, unet.py, vae.py), none elsewhere."""
    return "silu" if name.endswith(("norm1", "norm2", "conv_norm_out")) else None


@contextlib.contextmanager
def groupnorm_hooks(pipe, hook):
    """``hook(name, module, x, y)`` after every GroupNorm32 of the UNet and
    the VAE."""
    from gswm_torch.models.layers import GroupNorm32

    handles = [
        m.register_forward_hook(lambda m, args, y, name=name: hook(name, m, args[0], y))
        for model in (pipe.unet, pipe.vae) for name, m in model.named_modules()
        if isinstance(m, GroupNorm32)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def drive_groupnorm_sites(pipe) -> None:
    """One UNet forward at batch 2 and at 4 (guidance), one VAE decode of
    one image and one encode of two, at 768x768."""
    with torch.inference_mode():
        for b in (BATCH_768, 2 * BATCH_768):
            pipe.unet(*unet_inputs(pipe, b))
        g = torch.Generator(device="cuda").manual_seed(3)
        pipe.vae.decode(torch.randn((1, 4, RES_768 // 8, RES_768 // 8), generator=g,
                                    device="cuda", dtype=torch.bfloat16))
        pipe.vae.encode(torch.rand((BATCH_768, 3, RES_768, RES_768), generator=g,
                                   device="cuda", dtype=torch.bfloat16) * 2 - 1)
    torch.cuda.synchronize()


def groupnorm_cases(pipe) -> list:
    """Every distinct (shape, eps, act) of the 768x768 path's GroupNorms."""
    cases = []

    def hook(name, m, x, y):
        case = (tuple(x.shape), m.eps, groupnorm_act(name))
        if case not in cases:
            cases.append(case)

    with groupnorm_hooks(pipe, hook):
        drive_groupnorm_sites(pipe)
    print(f"GroupNorm cases of the 768x768 path: {len(cases)}", flush=True)
    return cases


def multikey_config():
    """The shared geometry of the per-user-key path: 512x512, l = 1, 256
    message bits (keys and nonces come with each record)."""
    from gswm_torch import GSConfig

    return GSConfig(width=RES_512, height=RES_512, message_bits=256)


def multikey_material(n: int = MULTIKEY_RECORDS, seed: int = MULTIKEY_SEED):
    """(keys, nonces, messages, records) of ``n`` users from a numpy seed;
    records in the info_data.jsonl schema of ``eval.registry``."""
    rng = np.random.default_rng(seed)
    raw = rng.bytes(80 * n)
    keys = [raw[80 * i:80 * i + 32] for i in range(n)]
    nonces = [raw[80 * i + 32:80 * i + 48] for i in range(n)]
    messages = [raw[80 * i + 48:80 * i + 80] for i in range(n)]
    records = [{"key_hex": k.hex(), "nonce_hex": m.hex(), "message_hex": g.hex(),
                "message_length": 256} for k, m, g in zip(keys, nonces, messages)]
    return keys, nonces, messages, records


def multikey_embed_all(cfg, keys, nonces, messages, dev="cuda", seed: int = 41):
    """Every record embedded under its own key, ``MULTIKEY_ROWS_PER_CALL`` rows
    a call: (n, 4, 64, 64) fp32 latents on ``dev``."""
    from gswm_torch.core.multikey import embed_latents_multikey

    g = torch.Generator(device=dev).manual_seed(seed)
    step = MULTIKEY_ROWS_PER_CALL
    return torch.cat([
        embed_latents_multikey(cfg, keys[i:i + step], nonces[i:i + step],
                               messages[i:i + step], generator=g, device=dev)[0]
        for i in range(0, len(keys), step)])


def multikey_decode_all(cfg, latents, keys, nonces) -> torch.Tensor:
    """(n, 256) voted bits, each row under its own key."""
    from gswm_torch.core.multikey import recover_message_bits_multikey

    step = MULTIKEY_ROWS_PER_CALL
    return torch.cat([
        recover_message_bits_multikey(latents[i:i + step], cfg, keys[i:i + step],
                                      nonces[i:i + step])
        for i in range(0, len(keys), step)])


# -- the robustness bench ------------------------------------------------------

ATTACK_REL_STRENGTH = 0.5
ATTACK_SEED = 808
SWEEP_SEED = 8
# the card's output against the CPU's, float32, the same draws: max |diff|
ATTACK_ATOL = 1e-4
# index arithmetic and masks alone: equal bit for bit
EXACT_ATTACKS = ("horizontal_flip", "vertical_flip", "invert", "erasing", "randomcrop")
# the DCT JPEG: the card and the CPU sum the 8x8 products in different orders,
# so a coefficient within an ulp of k + 1/2 may quantise one step apart and
# move its block by a quantisation step / 255; allowed on this share of the
# pixels, with this mean |diff| over all
JPEG_MAX_SHARE = 1e-3
JPEG_MEAN = 1e-4
# the round trip of the sweep's size-changing row: 768 -> int(768 * 0.3) -> 768
RESIZE_VIA = 230
TREERING_RADIUS = 10


def attack_names() -> list:
    """The 15 batched attacks, in the strength table's order."""
    from gswm_torch.distortions import DISTORTION_STRENGTH_PARAS

    return [name for name in DISTORTION_STRENGTH_PARAS if name != "reversed"]


def attack_images() -> torch.Tensor:
    """(2, 3, 768, 768) float32 images in [0, 1) from a seed, on the CPU."""
    return torch.rand((BATCH_768, 3, RES_768, RES_768),
                      generator=torch.Generator().manual_seed(ATTACK_SEED))


def attack_draws(name: str, shape):
    """One randomized attack's draws from a seed, on the CPU (so the card and
    the CPU are given the same numbers); None for a deterministic attack."""
    import zlib

    g = torch.Generator().manual_seed(ATTACK_SEED + zlib.crc32(name.encode()))
    if name == "noise":
        return torch.randn(shape, generator=g)
    if name in ("resizedcrop", "erasing", "randomcrop"):
        u = torch.rand(2, generator=g)
        return (u[0], u[1])
    if name == "elastic":
        u = torch.rand((2,) + tuple(shape[-2:]), generator=g)
        return (u[0], u[1])
    return None


def to_device(draws, dev):
    if draws is None:
        return None
    return draws.to(dev) if torch.is_tensor(draws) else tuple(d.to(dev) for d in draws)


def attack_disagreement(name: str, got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(max |diff|, share of pixels beyond ATTACK_ATOL) of one attack's output
    on the card (``got``, brought to the CPU) against the CPU's; raises where
    the pair is outside what the attack is held to."""
    if got.shape != want.shape or got.dtype != torch.float32:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} on the card, "
                             f"{tuple(want.shape)} on the CPU")
    diff = (got - want).abs()
    worst, share = diff.max().item(), (diff > ATTACK_ATOL).float().mean().item()
    if name in EXACT_ATTACKS:
        ok = worst == 0.0
    elif name == "compression":
        ok = share <= JPEG_MAX_SHARE and diff.mean().item() <= JPEG_MEAN
    else:
        ok = worst <= ATTACK_ATOL
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: the card and the CPU disagree: max |diff| "
                             f"{worst}, share beyond {ATTACK_ATOL}: {share}")
    return worst, share


def treering_material(dev="cuda", seed: int = 606):
    """(mask, ring pattern, marked and unmarked latents) for the Tree-Ring
    loop: 2 + 2 latents of 4 x 96 x 96, the pattern in channel 0."""
    from gswm_torch import treering

    shape = (BATCH_768, 4, RES_768 // 8, RES_768 // 8)
    g = torch.Generator(device=dev).manual_seed(seed)
    mask = treering.get_watermarking_mask(shape, 0, TREERING_RADIUS, device=dev)
    pattern = treering.get_watermarking_pattern(shape, "ring", TREERING_RADIUS,
                                                generator=g, device=dev)
    noise = torch.randn((2,) + shape, generator=g, device=dev)
    return mask, pattern, treering.inject_watermark(noise[0], mask, pattern), noise[1]


# The VAE fit (chip_smoke.py's fit phase): sd-2-1-base's VAE, which sd-2-1
# shares (VAEConfig()), from a seed, in float32 master parameters; two of
# tools/fit_vae.py's three stages, (latent side, steps, batch, lr), each cut
# to the steps that fit its share of the phase on one H100: about 120 s of
# the 16 stage's 1500 steps and 60 s of the 64 stage's 250 (the tool's
# full stages: ``fit_vae.STAGES``); the 32 stage is left to the tool
FIT_PRESET = "sd-2-1-base"
FIT_SEED = 0
FIT_STAGES = ((16, 720, 32, 1e-3), (64, 90, 8, 1e-4))
# sign fidelity read before the fit, and after it (96: 768x768, forward
# only, where the VAE mid attention takes K4)
FIDELITY_BEFORE = (16, 64)
FIDELITY_AFTER = (16, 64, 96)
# the reference's rows of the robustness bench at 768x768 on its fitted VAE
REFERENCE_SWEEP_768 = os.path.join("benchmarks", "robustness_sweep_sd21arch_768_tpu.jsonl")


def reference_rows_768(strength: float = ATTACK_REL_STRENGTH) -> dict:
    """{attack: bit_accuracy_mean} of the reference's 768x768 sweep at
    relative ``strength`` (the ``none`` row at 0): accuracies, no time."""
    import json

    rows = {}
    with open(REFERENCE_SWEEP_768) as f:
        for line in f:
            r = json.loads(line)
            if r["attack"] == "none" or r["relative_strength"] == strength:
                rows[r["attack"]] = r["bit_accuracy_mean"]
    return rows


# The command-line path (chip_smoke.py's cli phase): sd-2-1-base at 512x512
# on the fitted VAE, four users, one gs-embed-torch call each
CLI_KEYS = tuple(f"{0x51 + i:02x}" * 32 for i in range(4))
CLI_NONCES = tuple(f"{0x61 + i:02x}" * 16 for i in range(4))
CLI_SEED = 900
CLI_MESSAGE_BITS = 256


# The CLIP quality score (chip_smoke.py phase 11b): openai/clip-vit-large-patch14's
# published widths as its config.json gives them (vision 1024 wide, 24 layers,
# 16 heads, patch 14 at 224x224; text 768 wide, 12 layers, 12 heads;
# projection 768; quick_gelu; legacy eos_token_id 2), random weights from
# CLIP_SEED: no CLIP checkpoint is in the repository
CLIP_VIT_L14 = {
    "text_config": {"vocab_size": 49408, "hidden_size": 768, "intermediate_size": 3072,
                    "num_hidden_layers": 12, "num_attention_heads": 12,
                    "max_position_embeddings": 77, "hidden_act": "quick_gelu",
                    "layer_norm_eps": 1e-5, "eos_token_id": 2},
    "vision_config": {"hidden_size": 1024, "intermediate_size": 4096,
                      "num_hidden_layers": 24, "num_attention_heads": 16,
                      "image_size": 224, "patch_size": 14, "hidden_act": "quick_gelu",
                      "layer_norm_eps": 1e-5},
    "projection_dim": 768,
}
# CLIPImageProcessor's settings of that checkpoint (preprocessor_config.json)
CLIP_PROCESSOR = {"size": {"shortest_edge": 224}, "crop_size": {"height": 224, "width": 224},
                  "resample": 3, "rescale_factor": 1 / 255,
                  "image_mean": [0.48145466, 0.4578275, 0.40821073],
                  "image_std": [0.26862954, 0.26130258, 0.27577711]}
CLIP_SEED = 12
# eight prompts for the quality score (chip_smoke.py phase 11b)
CLIP_PROMPTS = ("a photograph of an astronaut riding a horse",
                "an oil painting of a lighthouse at dusk", "a red apple on a wooden table",
                "a city street in the rain at night", "a watercolor of mountains",
                "a cat sleeping on a sofa", "a bowl of ramen, studio lighting",
                "a sailing boat on a calm sea")


def write_clip_dir(directory: str, model) -> str:
    """A CLIP checkpoint directory for ``model`` (a ``ClipModel`` of
    ``CLIP_VIT_L14``): config.json, model.safetensors, preprocessor_config.json,
    and a byte-level vocabulary (every byte character, with and without
    ``</w>``, no merges; the specials last), since no CLIP tokenizer files
    are in the repository."""
    import json

    from gswm_torch.models.loader import write_safetensors
    from gswm_torch.models.tokenizer import bytes_to_unicode

    os.makedirs(directory, exist_ok=True)
    chars = list(bytes_to_unicode().values())
    vocab = {t: i for i, t in enumerate(chars + [c + "</w>" for c in chars]
                                         + ["<|startoftext|>", "<|endoftext|>"])}
    files = {"config.json": CLIP_VIT_L14, "preprocessor_config.json": CLIP_PROCESSOR,
             "vocab.json": vocab}
    for name, content in files.items():
        with open(os.path.join(directory, name), "w") as f:
            json.dump(content, f)
    with open(os.path.join(directory, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    write_safetensors(os.path.join(directory, "model.safetensors"), model.state_dict())
    return directory


# The quality artifact in the smoke (phase 11a): a batch of 8 a population at
# 30 steps (the tool's default is 64); the latent rows' KS p-values of
# wm_indep must each be at least QUALITY_MIN_P
QUALITY_BATCH = 8
QUALITY_MIN_P = 0.01
# At the tool's default seed 2024 the plain population of 8 images happens to
# sit 2.75 standard errors from mean 0, and wm_indep's two-sample p against
# it reads 0.006 (wm_indep against the exact N(0, 1): 0.44); the smoke takes
# the next seed.  ``run_quality_artifact --latent-seeds N`` prints the
# p-values across seeds, one draw of U(0, 1) each under the lossless claim.
QUALITY_SEED = 2025

# The memory sweep of utils/memory.py (phases 3, 4 and 9): (res, batches),
# each at or above the VAE encoder's chunk of images at that size (32, 14, 8),
# 2 inversion steps
MEMORY_SWEEPS = {"sd-2-1-base": (512, (32, 64, 128)), "sd-2-1": (768, (16, 32, 64)),
                 "sdxl-base": (1024, (8, 16, 32))}
MEMORY_STEPS = 2
