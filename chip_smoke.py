"""Drive the PyTorch port's paths once on one NVIDIA GPU (H100).

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure raises and exits nonzero:
  0. card     — refuse to run without CUDA; print the card's name and power
                limit (nvidia-smi).
  1. build    — compile gswm_torch/csrc/*.cu with nvcc (sm_90a), one nvcc
                process per source, all started together.
  2. kernels  — each kernel against its plain PyTorch version on the card at
                every shape the paths below give it, with the stated bounds;
                CUDA-event times of both, the least time the card could take
                (bound_ms, gswm_torch/roofline.py: FLOP over 989 TFLOP/s or
                bytes over 3.35 TB/s) and the time of one PyTorch call for
                the same function on the same tensors (library_ms: a
                yardstick the port never calls; the library's attention with
                its fused backends and, where those refuse the tensors, with
                its own choice, the backend printed; null where there is no
                such call or it refuses the shape).  K1's projection GEMM
                also alone,
                against x @ W^T in fp32.  The JSON line's ms, plain_ms,
                bound_ms and library_ms sum a kernel's shapes; its
                max_abs_err is their maximum.  K4 (csrc/flash_split.cu)
                also at D = 128 and 192 beside the VAE's 512, K7 also at an
                S % 8 != 0 shape, which its masked kernel serves.  K8
                (fused GroupNorm) at every distinct (shape, eps, act) of the
                768x768 path's GroupNorms, collected by forward hooks during
                one UNet forward at batch 2 and at 4, one VAE decode of one
                image and one encode of two.
  3. extraction path, sd-2-1-base at 512x512, batch 4 (full batch; the time
     limit does not need a smaller one), random weights from a seed:
       (a) latent closed loop: embed -> 30-step DDIM generate -> 30-step
           inversion -> decode; voted bit accuracy >= 0.99 on every image;
       (b) the extraction chain (bench.py:173-177) on random images: embed +
           VAE encode + 30-step inversion + decode; finite, shaped, timed.
     K1, K2 and K3 must launch (K1/K2 exactly 10/5 per UNet forward); K4
     must not (the VAE attention's 4096 tokens keep the plain path).
  4. generation path, sd-2-1 (v-prediction) at 768x768, batch 2, random
     weights from a seed:
       (a) latent closed loop with DDIM at guidance 1.0, and (b) with DPM++:
           bit accuracy >= 0.99 on every image;
       (c) the watermark chain: embed -> seeded prompt ids -> 30-step DDIM at
           guidance 7.5 -> VAE decode -> VAE encode -> 30-step inversion ->
           decode; finite images in [0, 1], generation and extraction
           images/s (second pass).
     K4 must launch once per VAE chunk of (c): 2 decoder and 1 encoder
     launches at batch 2; K1, K2 and K3 must launch too.
  5. attention tiers, sd-2-1 at 768x768, batch 2: under each of the JAX
     package's switch sets in turn (the environment restored after each) —
       (a) GSWM_XF_ATTN=0: cres, K2 at level 0;
       (b) GSWM_XF_ATTN=0 GSWM_CRES_ATTN=0 GSWM_PACKED_ATTN=1: K6;
       (c) GSWM_XF_ATTN=0 GSWM_CRES_ATTN=0 GSWM_TRANSPOSED_ATTN=1: K7;
       (d) GSWM_FUSED_QKV_MODE=seqhead: K1, which serves the seqhead K5;
       (e) GSWM_FUSED_QKV=0: K4 at level 1, plain attention at level 2 —
     one UNet forward on the same latents, timestep and context as the
     default route, within TIER_REL_BOUND of it, with exact launch counts;
     its ms (CUDA events); and the latent closed loop (embed -> 30-step DDIM
     -> 30-step inversion -> decode) at bit accuracy >= 0.99 on every image.
  6. GroupNorm op — K8 on the inputs of every GroupNorm of one UNet forward
     (batch 2), one decode and one encode at 768x768, each against the
     model's own GroupNorm output; one launch per GroupNorm.
  7. summary  — a JSON line of the kernels, then the JSON result line.
Each path's launch counts are set to 0 just before it and read just after.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import warnings

import torch
import torch.nn.functional as F

from gswm_torch.tools import paths
from gswm_torch.tools.paths import (BATCH_768, KEY_HEX, NONCE_HEX, RES_768, STEPS)

BATCH, RES = paths.BATCH_512, paths.RES_512
# counter low word 2^32 - 5: the 64-bit block counter carries at block 5
CARRY_NONCE_HEX = (2**32 - 5).to_bytes(8, "little").hex() + "44" * 8

MIN_BIT_ACC = 0.99
# bf16 kernel vs fp32 plain version at unit-scale inputs: tightened from the
# 0.06 of tests/test_fused_qkv_attention.py:51-64; the kernels measured
# <= 0.006 at these shapes on an H100
ATTN_BOUND = 0.02
# and relative to the largest output entry: over thousands of keys a typical
# entry is ~0.02, so the absolute bound alone would pass an error of a few
# percent; bf16 rounding of p and of the output is ~0.4% of it
ATTN_REL_BOUND = 0.02
# K1's projection GEMM alone against x @ W^T in fp32, unit-scale x and
# C^-0.5-scale weights (outputs ~N(0, 1), below 8 in magnitude, where one
# bf16 rounding is at most 2^-6): absolute, and relative to max |want|
PROJ_BOUND = 0.02
PROJ_REL_BOUND = 0.01
# K8 against its fp32 plain version: bf16 rounding of outputs below 8 is at
# most 2^-6 / 2 = 0.0078 (GroupNorm outputs of unit-scale affine stay below
# ~6 at these sizes), and 1% of the largest output entry
GN_BOUND = 0.02
GN_REL_BOUND = 0.01
# a tier's UNet output against the default route's, relative to the largest
# entry: the routes compute one function in bf16 and differ by rounding at
# different points (projection GEMM shapes, padded to_out), which the
# 16 transformer blocks carry through; a wrong head or layout moves the
# output by O(1)
TIER_REL_BOUND = 0.05
# attention launches per UNet forward at 768x768 under each switch set of
# paths.TIER_SWITCHES; every other attention counter must stay 0
TIER_LAUNCHES = {
    "a": {"flash_attention": 5, "fused_qkv_attention": 10},
    "b": {"flash_attention_packed": 5, "fused_qkv_attention": 10},
    "c": {"flash_attention_transposed": 5, "fused_qkv_attention": 10},
    "d": {"flash_attention": 5, "fused_qkv_attention": 10},
    "e": {"flash_attention": 5, "flash_attention_split": 5},
}
ATTENTION_COUNTERS = ("fused_qkv_attention", "flash_attention", "flash_attention_split",
                      "flash_attention_packed", "flash_attention_transposed")
# gswm/pipelines/inversable.py:330-348: VAE calls take vae_chunk images at
# 512x512, fewer in proportion to the pixels, and 8x fewer when decoding
VAE_CHUNK = 32


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


def _library_ms(fn, iters: int, what: str = "library call"):
    """Time of the PyTorch call ``fn``; None, with its message and the
    reasons PyTorch warns of, if it refuses these tensors."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        try:
            return _time_ms(fn, iters)
        except RuntimeError as e:
            torch.cuda.synchronize()
            why = sorted({str(w.message).split(" (Triggered")[0] for w in seen})
            print(f"   {what} refused: {str(e).splitlines()[0][:120]} "
                  f"{' | '.join(why)[:400]}", flush=True)
            return None


def _sdpa_fused(q, k, v):
    """The library's attention on (B, H, S, D) views, held to its fused
    backends (one kernel a call)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                      SDPBackend.CUDNN_ATTENTION]):
        return F.scaled_dot_product_attention(q, k, v)


def _attention_library_ms(fn, iters: int):
    """(ms, backend) of the one PyTorch call that computes an attention
    case, ``fn(sdpa)``: with the fused backends first and, where they refuse
    the tensors (a head dim above 256, a last stride other than 1), with the
    call's own choice of backend, which then is the math path: still one
    call, but several kernels and an (Sq, Sk) logits array in device memory.
    (None, "none") only if that is refused too."""
    ms = _library_ms(lambda: fn(_sdpa_fused), iters, "library call, fused backends,")
    if ms is not None:
        return ms, "fused"
    ms = _library_ms(lambda: fn(F.scaled_dot_product_attention), iters,
                     "library call, any backend,")
    return ms, "none" if ms is None else "math"


def _heads_view(t, b, s, h):
    """(B, S, H*64) memory -> the (B, H, S, 64) view."""
    return t.view(b, s, h, 64).transpose(1, 2)


def _record(records: dict, name: str, err: float, ms: float, plain: float,
            bound: tuple, library) -> None:
    rec = records.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                                        bound_ms=0.0, bound_by={}, library_ms=0.0))
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    rec["ms"] += ms
    rec["plain_ms"] += plain
    rec["bound_ms"] += bound[0]
    rec["bound_by"][bound[1]] = rec["bound_by"].get(bound[1], 0.0) + bound[0]
    # one refused shape leaves the kernel's sum without a yardstick
    rec["library_ms"] = None if library is None or rec["library_ms"] is None \
        else rec["library_ms"] + library


def _fmt(ms) -> str:
    return "none" if ms is None else f"{ms:.4f}"


def phase_kernels(gn_cases) -> dict:
    """Each kernel vs its plain version; returns per-kernel records.
    ``gn_cases``: the (shape, eps, act) of K8's calls."""
    from gswm_torch import roofline
    from gswm_torch.core import chacha
    from gswm_torch.ops import attention as attn
    from gswm_torch.ops import groupnorm as gn

    dev = "cuda"
    records = {}
    key, nonce = bytes.fromhex(KEY_HEX), bytes.fromhex(NONCE_HEX)
    carry = bytes.fromhex(CARRY_NONCE_HEX)
    # 32 and 72 blocks: one 64x64x4 and one 96x96x4 latent of bits
    for n_blocks in (32, 72, 2**20):
        for nn in (nonce, carry):
            _check_keystream(key, nn, n_blocks)
        ms = _time_ms(lambda: chacha.keystream_words(key, nonce, n_blocks, dev), 50)
        plain = _time_ms(
            lambda: chacha.keystream_words_reference(key, nonce, n_blocks, dev), 5)
        bound = roofline.bound_ms(*roofline.chacha_cost(n_blocks), roofline.PEAK_INT32)
        print(f"K3 chacha20 ({n_blocks} blocks): bit-exact incl. counter carry; "
              f"{ms:.4f} ms (plain {plain:.4f}, bound {bound[0]:.6f} by {bound[1]}, "
              f"library none)", flush=True)
        _record(records, "chacha20", 0.0, ms, plain, bound, None)

    g = torch.Generator(device=dev).manual_seed(1234)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).bfloat16()

    # K1's projection GEMM alone, at K1's four shapes below
    for b, s, c, h in paths.K1_SHAPES:
        x = rand(b, s, c)
        ws = [rand(h * 64, c, scale=c**-0.5) for _ in range(3)]
        w_cat = torch.cat(ws)
        got = attn.qkv_projection(x, *ws)
        want = [x.float() @ w.float().t() for w in ws]
        err = max((a.float() - w).abs().max().item() for a, w in zip(got, want))
        top = max(w.abs().max().item() for w in want)
        ms = _time_ms(lambda: attn.qkv_projection(x, *ws), 20)
        bound = roofline.bound_ms(*roofline.projection_cost(b * s, c, h * 64),
                                  roofline.PEAK_BF16)
        lib = _library_ms(lambda: F.linear(x, w_cat), 20)
        print(f"K1 projection GEMM (B={b}, S={s}, C={c}, H={h}): max|err| {err:.5f} "
              f"(bound {PROJ_BOUND}), err/max|want| {err / top:.5f} (bound "
              f"{PROJ_REL_BOUND}); {ms:.4f} ms (bound {bound[0]:.4f} by {bound[1]}, "
              f"library {_fmt(lib)})", flush=True)
        if not (err <= PROJ_BOUND and err <= PROJ_REL_BOUND * top):
            raise AssertionError(f"K1 projection GEMM at {(b, s, c, h)}: error {err} "
                                 f"above {PROJ_BOUND} or {PROJ_REL_BOUND} x {top}")
        del got, want

    # (label, record, kernel, plain version, library call given the attention
    # function to use, (FLOP, bytes), iterations) at the shapes of
    # gswm_torch/tools/paths.py
    cases = []
    for b, s, c, h in paths.K1_SHAPES:
        x = rand(b, s, c)
        ws = [rand(h * 64, c, scale=c**-0.5) for _ in range(3)]
        w_cat = torch.cat(ws)

        def k1_library(sdpa, x=x, w_cat=w_cat, b=b, s=s, h=h):
            q, k, v = F.linear(x, w_cat).split(h * 64, dim=-1)
            return sdpa(*(_heads_view(t, b, s, h) for t in (q, k, v)))

        cases.append((f"K1 fused_qkv (B={b}, S={s}, C={c}, H={h})",
                      "fused_qkv_attention",
                      lambda x=x, ws=ws, h=h: attn.fused_qkv_attention(x, *ws, h),
                      lambda x=x, ws=ws, h=h: attn.fused_qkv_attention_reference(
                          x.float(), *(w.float() for w in ws), h),
                      k1_library, roofline.fused_qkv_cost(b, s, c, h), 20))
    for b, s, h in paths.K2_SHAPES:
        q, k, v = (rand(b, s, h * 64) for _ in range(3))
        cases.append((f"K2 flash (B={b}, S={s}, H={h})", "flash_attention",
                      lambda q=q, k=k, v=v, h=h: attn.flash_attention(q, k, v, h),
                      lambda q=q, k=k, v=v, h=h: attn.flash_attention_reference(
                          q.float(), k.float(), v.float(), h),
                      lambda sdpa, q=q, k=k, v=v, b=b, s=s, h=h: sdpa(
                          *(_heads_view(t, b, s, h) for t in (q, k, v))),
                      roofline.attention_cost(b, s, s, h, 64), 10))
    # K4: the split wrapper runs csrc/flash_split.cu from D = 128 up (512 in
    # the VAE; 128 and 192, an odd panel count, beside it) and
    # csrc/flash_hopper.cu at D = 64: a record for each
    for b, s, h, d in paths.K4_SHAPES:
        q, k, v = (rand(b, s, h, d) for _ in range(3))
        cases.append((f"K4 flash_split (B={b}, S={s}, H={h}, D={d})",
                      "flash_attention_split_d64" if d == 64 else "flash_attention_split",
                      lambda q=q, k=k, v=v: attn.flash_attention_split(q, k, v),
                      lambda q=q, k=k, v=v: attn.flash_attention_split_reference(
                          q.float(), k.float(), v.float()),
                      lambda sdpa, q=q, k=k, v=v: sdpa(
                          *(t.transpose(1, 2) for t in (q, k, v))),
                      roofline.attention_cost(b, s, s, h, d), 10))
    # K6 and K7: UNet level 0 under their switches (5 heads: 3 pairs, the
    # last half a zero pad head).  The library call reads the kernel's own
    # layout through strided views (K6's with the pad head, K7's with a last
    # stride of B * S).  K6's bound counts the real heads alone: the pad
    # head's work is a loss of the layout, not work the UNet asks for
    for b, s, h in paths.LEVEL0_SHAPES:
        pairs = paths.pairs_of(h)
        qkv = rand(b, s, 3 * pairs * 128)
        for i in range(3):  # the pad head's projection rows are zero
            qkv[..., i * pairs * 128 + h * 64:(i + 1) * pairs * 128] = 0
        cases.append((f"K6 flash_packed (B={b}, S={s}, H={h}, P={pairs})",
                      "flash_attention_packed",
                      lambda qkv=qkv: attn.flash_attention_packed(qkv),
                      lambda qkv=qkv: attn.flash_attention_packed_reference(
                          qkv.float()),
                      lambda sdpa, qkv=qkv, pairs=pairs: sdpa(
                          *(t.unflatten(-1, (2 * pairs, 64)).transpose(1, 2)
                            for t in qkv.split(pairs * 128, dim=-1))),
                      roofline.attention_cost(b, s, s, h, 64), 10))
    # K7's last shape (S % 8 != 0) takes its masked kernel, the rest the
    # wgmma + TMA one
    for b, s, h in paths.K7_SHAPES:
        qkv_t = rand(3 * h * 64, b, s)
        cases.append((f"K7 flash_transposed (B={b}, S={s}, H={h})",
                      "flash_attention_transposed",
                      lambda qkv_t=qkv_t, h=h: attn.flash_attention_transposed(qkv_t, h),
                      lambda qkv_t=qkv_t, h=h: attn.flash_attention_transposed_reference(
                          qkv_t.float(), h),
                      lambda sdpa, qkv_t=qkv_t, b=b, s=s, h=h: sdpa(
                          *qkv_t.view(3, h, 64, b, s).permute(0, 3, 1, 4, 2)),
                      roofline.attention_cost(b, s, s, h, 64), 10))
    for label, name, kernel, plain_fn, library_fn, cost, iters in cases:
        got = kernel().float()
        want = plain_fn()
        err = (got - want).abs().max().item()
        top = want.abs().max().item()
        ms = _time_ms(kernel, iters)
        plain = _time_ms(plain_fn, 3)
        bound = roofline.bound_ms(*cost, roofline.PEAK_BF16)
        lib, backend = _attention_library_ms(library_fn, iters)
        print(f"{label}: max|err| {err:.5f} (bound {ATTN_BOUND}), max|want| "
              f"{top:.5f}, err/max|want| {err / top:.5f} (bound {ATTN_REL_BOUND}); "
              f"{ms:.4f} ms (plain {plain:.4f}, bound {bound[0]:.4f} by {bound[1]}, "
              f"library {_fmt(lib)}, backend {backend})", flush=True)
        if not (err <= ATTN_BOUND and err <= ATTN_REL_BOUND * top):
            raise AssertionError(f"{label}: error {err} above {ATTN_BOUND} or "
                                 f"{ATTN_REL_BOUND} x {top}")
        _record(records, name, err, ms, plain, bound, lib)
        del got, want
    # K8: unit-scale inputs with an offset, near-unit affine; the library
    # call is F.group_norm (+ F.silu) in bf16
    for shape, eps, act in gn_cases:
        x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).bfloat16()
        w = 1 + 0.05 * torch.randn(shape[1], generator=g, device=dev)
        bias = 0.05 * torch.randn(shape[1], generator=g, device=dev)
        got = gn.fused_group_norm(x, w, bias, 32, eps, act).float()
        want = gn.fused_group_norm_reference(x.float(), w, bias, 32, eps, act)
        err = (got - want).abs().max().item()
        top = want.abs().max().item()
        ms = _time_ms(lambda: gn.fused_group_norm(x, w, bias, 32, eps, act), 10)
        plain = _time_ms(lambda: gn.fused_group_norm_reference(x, w, bias, 32, eps, act), 3)
        bound = roofline.bound_ms(*roofline.group_norm_cost(shape), roofline.PEAK_FP32)
        wb, bb = w.bfloat16(), bias.bfloat16()

        def gn_library():
            y = F.group_norm(x, 32, wb, bb, eps)
            return F.silu(y) if act == "silu" else y

        lib = _library_ms(gn_library, 10)
        print(f"K8 group_norm {shape} eps {eps} act {act}: max|err| {err:.5f} (bound "
              f"{GN_BOUND}), err/max|want| {err / top:.5f} (bound {GN_REL_BOUND}); "
              f"{ms:.4f} ms (plain {plain:.4f}, bound {bound[0]:.4f} by {bound[1]}, "
              f"library {_fmt(lib)})", flush=True)
        if not (err <= GN_BOUND and err <= GN_REL_BOUND * top):
            raise AssertionError(f"K8 at {shape}: error {err} above {GN_BOUND} or "
                                 f"{GN_REL_BOUND} x {top}")
        _record(records, "fused_group_norm", err, ms, plain, bound, lib)
        del x, got, want
    for rec in records.values():  # the roof behind most of the summed bound
        rec["bound_by"] = max(rec["bound_by"], key=rec["bound_by"].get)
    return records


def _wrappers() -> dict:
    from gswm_torch.core import chacha
    from gswm_torch.ops import attention as attn
    from gswm_torch.ops import groupnorm as gn

    return {"chacha20": chacha.keystream_words,
            **{name: getattr(attn, name) for name in ATTENTION_COUNTERS},
            "fused_group_norm": gn.fused_group_norm}


def _counters() -> dict:
    """Each wrapper's launches; and, of the split wrapper's, those at
    D = 64, which another kernel runs."""
    counts = {name: fn.launches for name, fn in _wrappers().items()}
    counts["flash_attention_split_d64"] = _wrappers()["flash_attention_split"].launches_d64
    return counts


def _reset_counters() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
    _wrappers()["flash_attention_split"].launches_d64 = 0


def _check_unet_launches(counts: dict, forwards: int) -> None:
    """Every UNet forward at 512x512 and 768x768 has 5 level-1 + 5 level-2
    self-attention sites (K1) and 5 level-0 sites (K2); with no switch set
    the packed and transposed tiers (K6, K7) never run."""
    if counts["fused_qkv_attention"] != 10 * forwards or \
            counts["flash_attention"] != 5 * forwards or \
            counts["flash_attention_packed"] or counts["flash_attention_transposed"]:
        raise AssertionError(f"unexpected attention launch counts {counts} "
                             f"for {forwards} UNet forwards")


def _bit_accuracy(bits, msg: bytes, dev) -> list:
    from gswm_torch.core import bits as bitops

    want = torch.from_numpy(bitops.bytes_to_bits(msg)).to(dev)
    return (bits == want).float().mean(dim=1).tolist()


def phase_extraction_512(card: str) -> dict:
    from gswm_torch import recover_message_bits

    dev = "cuda"
    t0 = time.perf_counter()
    pipe = paths.build_pipeline("sd-2-1-base")
    n_unet = sum(p.numel() for p in pipe.unet.parameters())
    torch.cuda.synchronize()
    print(f"pipeline: sd-2-1-base, UNet {n_unet / 1e6:.1f}M params, "
          f"built in {time.perf_counter() - t0:.2f} s", flush=True)
    cfg = paths.config(RES, "gswm_torch")

    _reset_counters()
    # (a) latent closed loop
    c0 = _counters()
    zt, msg = paths.embed(cfg, BATCH, 5)
    c_embed = _counters()
    x0 = pipe.generate(zt, guidance_scale=1.0, num_steps=STEPS, decode=False)
    z_back = pipe.invert(latents=x0, num_steps=STEPS)
    c_inv = _counters()
    bits = recover_message_bits(z_back, cfg)
    c_dec = _counters()
    acc = _bit_accuracy(bits, msg, dev)
    sign = ((z_back > 0) == (zt > 0)).float().mean().item()
    print(f"(a) closed loop, batch {BATCH}, {STEPS}+{STEPS} steps: bit accuracy "
          f"{acc}, element sign agreement {sign:.4f}", flush=True)
    if min(acc) < MIN_BIT_ACC:
        raise AssertionError(f"closed-loop bit accuracy {acc} below {MIN_BIT_ACC}")
    if c_embed["chacha20"] <= c0["chacha20"] or c_dec["chacha20"] <= c_inv["chacha20"]:
        raise AssertionError("K3 did not launch in both embed and decode")

    # (b) the extraction chain on random images, once to warm up, once timed
    images = paths.random_images_512()
    walls = []
    for seed in (1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_bits, z_b, zt_b = paths.extraction_chain_512(pipe, cfg, images, seed)
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
    print(f"launches on the 512x512 extraction path: {counts}", flush=True)
    for name in ("chacha20", "fused_qkv_attention", "flash_attention"):
        if counts[name] < 1:
            raise AssertionError(f"kernel {name} never launched on the 512 path")
    if counts["flash_attention_split"]:
        raise AssertionError("K4 launched at 512x512, where the VAE attention "
                             "keeps the plain path")
    # (a) generate + invert, (b) two inversions: 4 x STEPS UNet forwards
    _check_unet_launches(counts, 4 * STEPS)
    return counts


def build_pipeline_768():
    t0 = time.perf_counter()
    pipe = paths.build_pipeline("sd-2-1")
    torch.cuda.synchronize()
    print(f"pipeline: sd-2-1 ({pipe.schedule.prediction_type}), built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if pipe.schedule.prediction_type != "v_prediction":
        raise AssertionError("sd-2-1 must run the v-prediction schedule")
    return pipe


def _groupnorm_act(name: str):
    """The activation after a GroupNorm: SiLU after every ResnetBlock norm
    and the final norms (layers.py, unet.py, vae.py), none elsewhere."""
    return "silu" if name.endswith(("norm1", "norm2", "conv_norm_out")) else None


@contextlib.contextmanager
def _groupnorm_hooks(pipe, hook):
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


def _drive_groupnorm_sites(pipe) -> None:
    """One UNet forward at batch 2 and at 4 (guidance), one VAE decode of
    one image and one encode of two, at 768x768."""
    with torch.inference_mode():
        for b in (BATCH_768, 2 * BATCH_768):
            pipe.unet(*paths.unet_inputs(pipe, b))
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
        case = (tuple(x.shape), m.eps, _groupnorm_act(name))
        if case not in cases:
            cases.append(case)

    with _groupnorm_hooks(pipe, hook):
        _drive_groupnorm_sites(pipe)
    print(f"GroupNorm cases of the 768x768 path: {len(cases)}", flush=True)
    return cases


def phase_generation_768(card: str, pipe) -> dict:
    from gswm_torch import recover_message_bits

    dev = "cuda"
    b = BATCH_768
    cfg = paths.config(RES_768, "gswm_torch 768")
    prompt_ids = paths.prompt_ids(pipe, b)

    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    forwards = 0
    # (a), (b): latent closed loops, guidance 1.0
    for scheduler in ("DDIM", "DPMs"):
        zt, msg = paths.embed(cfg, b, 11)
        x0 = pipe.generate(zt, guidance_scale=1.0, num_steps=STEPS,
                           scheduler=scheduler, decode=False)
        z_back = pipe.invert(latents=x0, num_steps=STEPS, scheduler=scheduler)
        acc = _bit_accuracy(recover_message_bits(z_back, cfg), msg, dev)
        forwards += 2 * STEPS
        print(f"({'a' if scheduler == 'DDIM' else 'b'}) 768 closed loop, "
              f"{scheduler}, batch {b}, {STEPS}+{STEPS} steps: bit accuracy {acc}",
              flush=True)
        if min(acc) < MIN_BIT_ACC:
            raise AssertionError(f"{scheduler} closed-loop bit accuracy {acc} "
                                 f"below {MIN_BIT_ACC}")

    # (c): the watermark chain, twice (the second pass is timed).  One K4
    # launch per VAE chunk: at 768x768 the decoder takes 1 image a call and
    # the encoder 14
    pixels = max(1.0, RES_768 * RES_768 / (512 * 512))
    dec_want = -(-b // max(1, int(VAE_CHUNK / (8 * pixels))))
    enc_want = -(-b // max(1, int(VAE_CHUNK / pixels)))
    for attempt in (1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k4_0 = _counters()["flash_attention_split"]
        images, msg = paths.generate_768(pipe, cfg, prompt_ids, 20 + attempt)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        k4_dec = _counters()["flash_attention_split"] - k4_0
        bits, z_t = pipe.extract_bits(cfg, images=images, num_steps=STEPS)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        k4_enc = _counters()["flash_attention_split"] - k4_0 - k4_dec
        forwards += 2 * STEPS
        if attempt == 1:
            first = (t1 - t0, t2 - t1)
            if (k4_dec, k4_enc) != (dec_want, enc_want):
                raise AssertionError(
                    f"K4 launches: decoder {k4_dec}, encoder {k4_enc}; the chunk "
                    f"rule gives {dec_want} and {enc_want}")
    if tuple(images.shape) != (b, 3, RES_768, RES_768):
        raise AssertionError(f"images shape {tuple(images.shape)}")
    if not torch.isfinite(images).all() or images.min() < 0 or images.max() > 1:
        raise AssertionError("images not finite in [0, 1]")
    if tuple(bits.shape) != (b, 256) or not torch.isfinite(z_t).all():
        raise AssertionError(f"bits shape {tuple(bits.shape)} or non-finite z_T")
    counts = _counters()
    peak = torch.cuda.max_memory_allocated() / 2**30
    acc = _bit_accuracy(bits, msg, dev)
    print(f"(c) 768 watermark chain, batch {b}: bit accuracy {acc} (no limit: a "
          f"random-weight VAE is not an autoencoder, so this says nothing about "
          f"the watermark)", flush=True)
    print(f"(c) generation (prompt, 30-step DDIM at guidance 7.5, VAE decode) "
          f"{t1 - t0:.4f} s = {b / (t1 - t0):.4f} images/s; extraction (VAE "
          f"encode, 30-step inversion, decode) {t2 - t1:.4f} s = "
          f"{b / (t2 - t1):.4f} images/s; first pass {first[0]:.4f} + "
          f"{first[1]:.4f} s; peak device memory {peak:.2f} GiB; on {card}",
          flush=True)
    print(f"launches on the 768x768 generation path: {counts}; K4 per chain: "
          f"decoder {k4_dec}, encoder {k4_enc}", flush=True)
    for name in ("chacha20", "fused_qkv_attention", "flash_attention",
                 "flash_attention_split"):
        if counts[name] < 1:
            raise AssertionError(f"kernel {name} never launched on the 768 path")
    _check_unet_launches(counts, forwards)
    return counts


def phase_tiers(card: str, pipe) -> dict:
    from gswm_torch import recover_message_bits

    dev = "cuda"
    b = BATCH_768
    cfg = paths.config(RES_768, "gswm_torch tiers")
    inputs = paths.unet_inputs(pipe, b)

    def forward():
        with torch.inference_mode():
            return pipe.unet(*inputs)

    with paths.route_switches({}):
        default = forward()
        default_ms = _time_ms(forward, 10)
    top = default.abs().max().item()
    print(f"5. default route: UNet forward {default_ms:.4f} ms at batch {b}, "
          f"max|out| {top:.4f}; on {card}", flush=True)
    total = {name: 0 for name in _counters()}
    for label, switches in paths.TIER_SWITCHES.items():
        per_forward = TIER_LAUNCHES[label]
        with paths.route_switches(switches):
            _reset_counters()
            out = forward()
            torch.cuda.synchronize()
            one = _counters()
            ms = _time_ms(forward, 10)
            _reset_counters()
            zt, msg = paths.embed(cfg, b, 31)
            x0 = pipe.generate(zt, guidance_scale=1.0, num_steps=STEPS, decode=False)
            z_back = pipe.invert(latents=x0, num_steps=STEPS)
            acc = _bit_accuracy(recover_message_bits(z_back, cfg), msg, dev)
            loop = _counters()
        diff = (out - default).abs().max().item()
        env = " ".join(f"{k}={v}" for k, v in switches.items())
        print(f"({label}) {env}: max|out - default| {diff:.5f}, relative "
              f"{diff / top:.5f} (bound {TIER_REL_BOUND}); UNet forward {ms:.4f} ms; "
              f"closed loop {STEPS}+{STEPS} steps bit accuracy {acc}; launches per "
              f"forward {({k: v for k, v in one.items() if v})}", flush=True)
        want = {name: per_forward.get(name, 0) for name in ATTENTION_COUNTERS}
        if {name: one[name] for name in ATTENTION_COUNTERS} != want:
            raise AssertionError(f"({label}) launches per forward {one}, want {want}")
        if {name: loop[name] for name in ATTENTION_COUNTERS} != \
                {name: n * 2 * STEPS for name, n in want.items()}:
            raise AssertionError(f"({label}) launches over the closed loop {loop}")
        if loop["chacha20"] < 2:
            raise AssertionError(f"({label}) K3 did not launch in embed and decode")
        if not diff <= TIER_REL_BOUND * top:
            raise AssertionError(f"({label}) UNet output {diff} from the default "
                                 f"route's, above {TIER_REL_BOUND} x {top}")
        if min(acc) < MIN_BIT_ACC:
            raise AssertionError(f"({label}) closed-loop bit accuracy {acc} below "
                                 f"{MIN_BIT_ACC}")
        for name in total:
            total[name] += loop[name]
    return total


def phase_groupnorm_op(pipe) -> dict:
    """K8 on the real inputs of the 768x768 path's GroupNorms, held against
    each module's own output (F.group_norm in fp32, rounded to bf16): within
    GN_REL_BOUND of max |want| — two bf16 roundings of fp32 values that
    differ in the last places may land one bf16 step apart, at most 2^-7 of
    the entry; the absolute bound of phase 2 assumes outputs below 8, which
    real activations need not keep."""
    from gswm_torch.ops import groupnorm as gn

    worst = [0.0, 0]

    def hook(name, m, x, y):
        got = gn.fused_group_norm(x.contiguous(), m.weight, m.bias, m.num_groups, m.eps)
        err = (got.float() - y.float()).abs().max().item()
        top = y.float().abs().max().item()
        if not err <= GN_REL_BOUND * top:
            raise AssertionError(f"K8 at {name} {tuple(x.shape)}: error {err} above "
                                 f"{GN_REL_BOUND} x {top}")
        worst[0] = max(worst[0], err / top)
        worst[1] += 1

    _reset_counters()
    with _groupnorm_hooks(pipe, hook):
        _drive_groupnorm_sites(pipe)
    counts = _counters()
    print(f"6. K8 on {worst[1]} GroupNorm inputs of the 768x768 path: max "
          f"|err| / max|want| {worst[0]:.5f} (bound {GN_REL_BOUND}); launches "
          f"{counts['fused_group_norm']}", flush=True)
    if counts["fused_group_norm"] != worst[1] or worst[1] < 1:
        raise AssertionError(f"K8 launched {counts['fused_group_norm']} times for "
                             f"{worst[1]} GroupNorms")
    return counts


def main() -> None:
    card = phase_card()
    phase_build()
    pipe_768 = build_pipeline_768()
    records = phase_kernels(groupnorm_cases(pipe_768))
    counts_512 = phase_extraction_512(card)
    torch.cuda.empty_cache()
    counts_768 = phase_generation_768(card, pipe_768)
    counts_tiers = phase_tiers(card, pipe_768)
    counts_gn = phase_groupnorm_op(pipe_768)
    counts = {name: counts_512[name] + counts_768[name] + counts_tiers[name]
              + counts_gn[name] for name in counts_512}
    # the split wrapper's count, less what flash_hopper.cu ran of it
    counts["flash_attention_split"] -= counts["flash_attention_split_d64"]
    sources = {
        "chacha20": ("gswm_torch/csrc/chacha20.cu",
                     "gswm/core/chacha.py:158"),
        "fused_qkv_attention": ("gswm_torch/csrc/fused_qkv.cu",
                                "gswm/ops/attention.py:689"),
        "flash_attention": ("gswm_torch/csrc/flash_hopper.cu",
                            "gswm/ops/attention.py:1211"),
        "flash_attention_split": ("gswm_torch/csrc/flash_split.cu",
                                  "gswm/ops/attention.py:414"),
        "flash_attention_split_d64": ("gswm_torch/csrc/flash_hopper.cu",
                                      "gswm/ops/attention.py:414"),
        "flash_attention_packed": ("gswm_torch/csrc/flash_hopper.cu",
                                   "gswm/ops/attention.py:959"),
        "flash_attention_transposed": ("gswm_torch/csrc/flash_transposed.cu",
                                       "gswm/ops/attention.py:1428"),
        "fused_group_norm": ("gswm_torch/csrc/group_norm.cu",
                             "gswm/ops/groupnorm.py:185"),
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
