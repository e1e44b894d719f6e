"""Drive the PyTorch port's extraction path once on one NVIDIA GPU (H100).

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure raises and exits nonzero:
  0. card     — refuse to run without CUDA; print the card's name and power
                limit (nvidia-smi).
  1. build    — compile gswm_torch/csrc/*.cu with nvcc (sm_90a).
  2. kernels  — each kernel against its plain PyTorch version on the card at
                the main path's shapes, with the stated bound; CUDA-event
                times of both.
  3. main path, sd-2-1-base at 512x512, batch 4, random weights from a seed:
       (a) latent closed loop: embed -> 30-step DDIM generate -> 30-step
           inversion -> decode; voted bit accuracy >= 0.99 on every image;
       (b) the extraction chain (bench.py:173-177) on random images: embed +
           VAE encode + 30-step inversion + decode; finite, shaped, timed.
     Every kernel's launch counter must have risen during (a) and (b).
  4. summary  — a JSON line of the kernels, then the JSON result line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

KEY_HEX = "22" * 32
NONCE_HEX = "33" * 16
# counter low word 2^32 - 5: the 64-bit block counter carries at block 5
CARRY_NONCE_HEX = (2**32 - 5).to_bytes(8, "little").hex() + "44" * 8

BATCH = 4
RES = 512
STEPS = 30
MIN_BIT_ACC = 0.99
# bf16 kernel vs fp32 plain version at unit-scale inputs: tightened from the
# 0.06 of tests/test_fused_qkv_attention.py:51-64; the kernels measured
# <= 0.006 at these shapes on an H100
ATTN_BOUND = 0.02


def phase_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's main path "
                         "runs only on the GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> None:
    from gswm_torch import native

    lib = native.library()
    ptxas = [ln.strip() for ln in lib.log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    for ln in ptxas:
        print(f"ptxas: {ln}")
    print(f"build: {lib.build_seconds:.2f} s -> {lib.path.name}", flush=True)


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _check_keystream(key: bytes, nonce: bytes, n_blocks: int) -> None:
    from gswm_torch.core import chacha

    got = chacha.keystream_words(key, nonce, n_blocks, "cuda")
    want = chacha.keystream_words_reference(key, nonce, n_blocks, "cuda")
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = (got != want).any(dim=1).nonzero()[:5].flatten().tolist()
        raise AssertionError(f"K3 keystream differs at {n_blocks} blocks, "
                             f"nonce {nonce.hex()}: blocks {bad}")


def phase_kernels() -> dict:
    """Each kernel vs its plain version; returns per-kernel records."""
    from gswm_torch.core import chacha
    from gswm_torch.ops import attention as attn

    dev = "cuda"
    key, nonce = bytes.fromhex(KEY_HEX), bytes.fromhex(NONCE_HEX)
    carry = bytes.fromhex(CARRY_NONCE_HEX)
    for n_blocks in (32, 2**20):
        for nn in (nonce, carry):
            _check_keystream(key, nn, n_blocks)
    ks_ms = _time_ms(lambda: chacha.keystream_words(key, nonce, 32, dev), 200)
    ks_plain = _time_ms(
        lambda: chacha.keystream_words_reference(key, nonce, 32, dev), 20)
    big_ms = _time_ms(lambda: chacha.keystream_words(key, nonce, 2**20, dev), 20)
    big_plain = _time_ms(
        lambda: chacha.keystream_words_reference(key, nonce, 2**20, dev), 5)
    print(f"K3 chacha20: bit-exact at 32 and 2^20 blocks incl. counter carry; "
          f"32 blocks {ks_ms:.4f} ms (plain {ks_plain:.4f}); "
          f"2^20 blocks {big_ms:.4f} ms (plain {big_plain:.4f})", flush=True)
    records = {"chacha20": dict(max_abs_err=0.0, ms=ks_ms, plain_ms=ks_plain)}

    g = torch.Generator(device=dev).manual_seed(1234)
    k1_err, k1_ms, k1_plain = 0.0, 0.0, 0.0
    for b, s, c, h in ((2, 1024, 640, 10), (2, 256, 1280, 20)):
        x = torch.randn((b, s, c), generator=g, device=dev).bfloat16()
        ws = [(torch.randn((h * 64, c), generator=g, device=dev) * c**-0.5)
              .bfloat16() for _ in range(3)]
        got = attn.fused_qkv_attention(x, *ws, h).float()
        want = attn.fused_qkv_attention_reference(
            x.float(), *(w.float() for w in ws), h)
        err = (got - want).abs().max().item()
        ms = _time_ms(lambda: attn.fused_qkv_attention(x, *ws, h), 20)
        plain = _time_ms(lambda: attn.fused_qkv_attention_reference(x, *ws, h), 10)
        print(f"K1 fused_qkv (B={b}, S={s}, C={c}, H={h}): max|err| {err:.5f} "
              f"(bound {ATTN_BOUND}); {ms:.4f} ms (plain {plain:.4f})", flush=True)
        if not err <= ATTN_BOUND:
            raise AssertionError(f"K1 error {err} above {ATTN_BOUND}")
        k1_err = max(k1_err, err)
        k1_ms, k1_plain = k1_ms + ms, k1_plain + plain
    records["fused_qkv_attention"] = dict(max_abs_err=k1_err, ms=k1_ms,
                                          plain_ms=k1_plain)

    b, s, h = 2, 4096, 5
    q, k, v = (torch.randn((b, s, h * 64), generator=g, device=dev).bfloat16()
               for _ in range(3))
    got = attn.flash_attention(q, k, v, h).float()
    want = attn.flash_attention_reference(q.float(), k.float(), v.float(), h)
    err = (got - want).abs().max().item()
    ms = _time_ms(lambda: attn.flash_attention(q, k, v, h), 20)
    plain = _time_ms(lambda: attn.flash_attention_reference(q, k, v, h), 5)
    print(f"K2 flash (B={b}, S={s}, H={h}): max|err| {err:.5f} "
          f"(bound {ATTN_BOUND}); {ms:.4f} ms (plain {plain:.4f})", flush=True)
    if not err <= ATTN_BOUND:
        raise AssertionError(f"K2 error {err} above {ATTN_BOUND}")
    records["flash_attention"] = dict(max_abs_err=err, ms=ms, plain_ms=plain)
    return records


def _counters() -> dict:
    from gswm_torch.core import chacha
    from gswm_torch.ops import attention as attn

    return {"chacha20": chacha.keystream_words.launches,
            "fused_qkv_attention": attn.fused_qkv_attention.launches,
            "flash_attention": attn.flash_attention.launches}


def _reset_counters() -> None:
    from gswm_torch.core import chacha
    from gswm_torch.ops import attention as attn

    for fn in (chacha.keystream_words, attn.fused_qkv_attention,
               attn.flash_attention):
        fn.launches = 0


def phase_main_path(card: str) -> dict:
    from gswm_torch import GSConfig, embed_latents, recover_message_bits
    from gswm_torch.core import bits as bitops
    from gswm_torch.pipelines import InversablePipeline

    dev = "cuda"
    t0 = time.perf_counter()
    pipe = InversablePipeline(
        "sd-2-1-base", device=dev, dtype=torch.bfloat16,
        generator=torch.Generator(device=dev).manual_seed(0))
    n_unet = sum(p.numel() for p in pipe.unet.parameters())
    torch.cuda.synchronize()
    print(f"pipeline: sd-2-1-base, UNet {n_unet / 1e6:.1f}M params, "
          f"built in {time.perf_counter() - t0:.2f} s", flush=True)
    cfg = GSConfig(key_hex=KEY_HEX, nonce_hex=NONCE_HEX, message="gswm_torch",
                   width=RES, height=RES, message_bits=256)

    _reset_counters()
    # (a) latent closed loop
    c0 = _counters()
    zt, msg = embed_latents(cfg, generator=torch.Generator(device=dev).manual_seed(5),
                            batch=BATCH, device=dev)
    c_embed = _counters()
    x0 = pipe.generate(zt, num_steps=STEPS)
    z_back = pipe.invert(latents=x0, num_steps=STEPS)
    c_inv = _counters()
    bits = recover_message_bits(z_back, cfg)
    c_dec = _counters()
    want = torch.from_numpy(bitops.bytes_to_bits(msg)).to(dev)
    acc = (bits == want).float().mean(dim=1).tolist()
    sign = ((z_back > 0) == (zt > 0)).float().mean().item()
    print(f"(a) closed loop, batch {BATCH}, {STEPS}+{STEPS} steps: bit accuracy "
          f"{acc}, element sign agreement {sign:.4f}", flush=True)
    if min(acc) < MIN_BIT_ACC:
        raise AssertionError(f"closed-loop bit accuracy {acc} below {MIN_BIT_ACC}")
    if c_embed["chacha20"] <= c0["chacha20"] or c_dec["chacha20"] <= c_inv["chacha20"]:
        raise AssertionError("K3 did not launch in both embed and decode")

    # (b) the extraction chain on random images, once to warm up, once timed
    images = torch.rand((BATCH, 3, RES, RES),
                        generator=torch.Generator(device=dev).manual_seed(99),
                        device=dev)

    def chain(seed):
        zt_b, _ = embed_latents(
            cfg, generator=torch.Generator(device=dev).manual_seed(seed),
            batch=BATCH, device=dev)
        lat = pipe.image_to_latents(images)
        z_b = pipe.invert(latents=lat, num_steps=STEPS)
        return recover_message_bits(z_b, cfg), z_b, zt_b

    walls = []
    for seed in (1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_bits, z_b, zt_b = chain(seed)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    if tuple(out_bits.shape) != (BATCH, 256):
        raise AssertionError(f"bits shape {tuple(out_bits.shape)}")
    if not (torch.isfinite(z_b).all() and torch.isfinite(zt_b).all()):
        raise AssertionError("non-finite latents in the extraction chain")
    counts = _counters()
    print(f"(b) extraction chain, batch {BATCH}, {RES}x{RES}, {STEPS} steps: "
          f"wall {walls[1]:.4f} s ({BATCH / walls[1]:.4f} images/s; first pass "
          f"{walls[0]:.4f} s) on {card}", flush=True)
    print(f"launches on the main path: {counts}", flush=True)
    for name, n in counts.items():
        if n < 1:
            raise AssertionError(f"kernel {name} never launched on the main path")
    # (a) generate + invert, (b) two inversions: 4 x STEPS UNet forwards, each
    # with 5 level-1 + 5 level-2 sites (K1) and 5 level-0 sites (K2)
    forwards = 4 * STEPS
    if counts["fused_qkv_attention"] != 10 * forwards or \
            counts["flash_attention"] != 5 * forwards:
        raise AssertionError(f"unexpected attention launch counts {counts} "
                             f"for {forwards} UNet forwards")
    return counts


def main() -> None:
    card = phase_card()
    phase_build()
    records = phase_kernels()
    counts = phase_main_path(card)
    sources = {
        "chacha20": ("gswm_torch/csrc/chacha20.cu",
                     "gswm/core/chacha.py:158"),
        "fused_qkv_attention": ("gswm_torch/csrc/fused_qkv.cu",
                                "gswm/ops/attention.py:689"),
        "flash_attention": ("gswm_torch/csrc/flash_attn.cu",
                            "gswm/ops/attention.py:1211"),
    }
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=counts[name], **records[name])
               for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
