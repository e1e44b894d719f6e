"""Where the device time of the port's paths goes, from ``torch.profiler``.

    python -m gswm_torch.tools.profile_paths [--out FILE.json] [--top 25]

On one card, random weights from a seed, bf16:

  * sd-2-1 at 768x768, batch 2: one UNet forward (device time, and the
    share and launches of each kernel), the same forward's device time under
    each attention switch set of ``paths.TIER_SWITCHES`` (``chip_smoke.py``
    phase 5), then the watermark chain of
    ``chip_smoke.py`` phase 4c (embed -> prompt ids -> 30-step DDIM at
    guidance 7.5 -> VAE decode -> VAE encode -> 30-step inversion -> decode)
    once unprofiled for its wall time and once under the profiler;
  * one row of the robustness sweep at 768x768, batch 2 (``chip_smoke.py``
    phase 8b; the ``compression`` row, whose attack is the slowest): the wall
    of its parts (attack, VAE encode, 30-step inversion, decode of the bits),
    then the whole row unprofiled and under the profiler;
  * sd-2-1-base at 512x512, batch 4: the extraction chain of phase 3b
    (embed + VAE encode + 30-step inversion + decode), likewise.
  * sdxl-base at 1024x1024, batch 2: one UNet forward as the 768x768 one,
    at batch 2 and at 4 (guidance), and the watermark chain of
    ``chip_smoke.py`` phase 9b (both text encoders, guidance 7.5, VAE decode,
    then VAE encode, 30-step inversion, decode), likewise.
  * sd-1-4 at 512x512, batch 4 (8 heads of 40, 80 and 160): one UNet forward
    at batch 4 and at 8 (guidance), and the watermark chain of
    ``chip_smoke.py`` phase 10b, likewise; its extraction half beside the
    512x512 chain of sd-2-1-base above.
  * the GroupNorm kernel (K8) at ``paths.K8_PROBE_CASES``: device time a call
    beside the wrapper's CUDA-event time a call, which holds its host side,
    and its bound.
  * the tracer itself, first and last in the run (a young and an old
    process): windows of 1 and of 8 calls of K8, 0.05 s of margin before
    the calls; a window's launch records on the host's side beside its
    kernel records on the device's, which an old process loses (the tracer's
    own log, ``KINETO_LOG_LEVEL=0``, counts them as out of range).
    ``chip_smoke.py`` counts kernels a call from the host's records for that
    reason.
Both chains, their inputs and seeds are ``gswm_torch/tools/paths.py``'s, as
``chip_smoke.py``'s are.

For each profiled run: wall time, device-busy time (the sum of kernel and
copy durations: the port runs one stream), the idle share 1 - busy / wall
(inflated by the profiler's own host cost; the unprofiled wall stands
beside it), the device records (kernels and copies) it holds, and the
kernels by device time.  Prints lines and, last, one
JSON object; ``--out`` also writes it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from gswm_torch import roofline
from gswm_torch.tools import paths
from gswm_torch.tools.compare_kernels import device_ms, time_ms


def profiled(fn, top: int) -> dict:
    """Run ``fn`` under the profiler; wall, busy, idle share, top kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in rows)
    if busy <= 0:
        raise RuntimeError("the profiler saw no device time")
    rows.sort(key=lambda r: -r[1])
    return dict(wall_s=wall, busy_s=busy / 1e3, idle_share=1 - busy / 1e3 / wall,
                device_records=sum(n for _, _, n in rows),
                kernels=[dict(name=k[:120], ms=ms, share=ms / busy, launches=n)
                         for k, ms, n in rows[:top]])


def report(title: str, res: dict) -> None:
    print(f"{title}: wall {res['wall_s']:.4f} s, device busy {res['busy_s']:.4f} s, "
          f"idle share {res['idle_share']:.4f}, {res['device_records']} device records",
          flush=True)
    for k in res["kernels"]:
        print(f"  {k['share'] * 100:6.2f}%  {k['ms']:10.3f} ms  x{k['launches']:<6d} "
              f"{k['name']}", flush=True)


def tracer_records(calls: int, windows: int = 5) -> list:
    """``windows`` profiler windows of ``calls`` K8 calls each.  A window:
    launch records on the host's side, kernel records on the device's."""
    from torch.profiler import ProfilerActivity, profile

    from gswm_torch.ops import groupnorm as gn

    shape, act = paths.K8_PROBE_CASES[-1]
    x = torch.randn(shape, device="cuda").bfloat16()
    w, b = torch.ones(shape[1], device="cuda"), torch.zeros(shape[1], device="cuda")
    gn.fused_group_norm(x, w, b, 32, 1e-5, act)
    out = []
    for _ in range(windows):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for _ in range(calls):
                gn.fused_group_norm(x, w, b, 32, 1e-5, act)
            torch.cuda.synchronize()
            time.sleep(0.05)
        events = prof.events()
        out.append(dict(
            calls=calls,
            host_launches=sum(e.device_type.name == "CPU" and "launch" in e.name.lower()
                              for e in events),
            device_records=sum(e.device_type.name == "CUDA" for e in events)))
    return out


def report_tracer(age: str, t0: float) -> dict:
    res = dict(process_age_s=time.perf_counter() - t0,
               windows=tracer_records(1) + tracer_records(8))
    print(f"tracer, {age} process ({res['process_age_s']:.0f} s into the run): (calls, "
          f"launch records on the host's side, kernel records on the device's) "
          f"{[tuple(w.values()) for w in res['windows']]}", flush=True)
    return res


def wall_of(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    started = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("profile_paths: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = {"card": card, "tracer_young": report_tracer("young", started)}

    # ---- sd-2-1, 768x768, batch 2
    pipe = paths.build_pipeline("sd-2-1")
    cfg = paths.config(paths.RES_768, "gswm_torch 768")
    ids = paths.prompt_ids(pipe, paths.BATCH_768)
    unet_in = paths.unet_inputs(pipe, paths.BATCH_768)

    def forward():
        with torch.inference_mode():
            for _ in range(3):
                pipe.unet(*unet_in)

    def chain_768(seed=21):
        paths.watermark_chain(pipe, cfg, ids, seed)

    forward()
    res_f = profiled(forward, args.top)
    res_f["forwards"] = 3
    report("768x768 UNet forward x3, batch 2", res_f)
    print(f"  device time per forward {res_f['busy_s'] / 3 * 1e3:.3f} ms", flush=True)
    result["unet_forward_768"] = res_f
    result["unet_forward_768_tiers"] = {}
    for label, switches in paths.TIER_SWITCHES.items():
        with paths.route_switches(switches):
            forward()
            res_t = profiled(forward, 3)
        env = " ".join(f"{k}={v}" for k, v in switches.items())
        print(f"  ({label}) {env}: device time per forward "
              f"{res_t['busy_s'] / 3 * 1e3:.3f} ms", flush=True)
        result["unet_forward_768_tiers"][label] = dict(
            device_ms_per_forward=res_t["busy_s"] / 3 * 1e3, top=res_t["kernels"])
    chain_768(20)
    result["chain_768_wall_s"] = wall_of(chain_768)
    print(f"768x768 chain, batch 2, unprofiled: wall {result['chain_768_wall_s']:.4f} s",
          flush=True)
    result["chain_768"] = profiled(chain_768, args.top)
    report("768x768 chain, batch 2, profiled", result["chain_768"])

    # ---- one sweep row on that pipeline
    from gswm_torch import recover_message_bits
    from gswm_torch.distortions import device as attacks
    from gswm_torch.distortions import relative_strength_to_absolute

    images, _ = paths.generate_watermarked(pipe, cfg, ids, 22)
    quality = relative_strength_to_absolute(paths.ATTACK_REL_STRENGTH, "compression")
    attacked = attacks.apply(images, "compression", quality)
    latents = pipe.image_to_latents(attacked)
    z_back = pipe.invert(latents=latents, num_steps=paths.STEPS)
    parts = {
        "attack": lambda: attacks.apply(images, "compression", quality),
        "vae_encode": lambda: pipe.image_to_latents(attacked),
        "inversion": lambda: pipe.invert(latents=latents, num_steps=paths.STEPS),
        "decode": lambda: recover_message_bits(z_back, cfg).cpu(),
    }
    result["sweep_row_parts_s"] = {name: wall_of(fn) for name, fn in parts.items()}

    def sweep_row():
        for fn in parts.values():
            fn()

    result["sweep_row_wall_s"] = wall_of(sweep_row)
    print(f"768x768 sweep row (compression at {quality:g}), batch 2, unprofiled: wall "
          f"{result['sweep_row_wall_s']:.4f} s; parts {result['sweep_row_parts_s']}",
          flush=True)
    result["sweep_row"] = profiled(sweep_row, args.top)
    report("768x768 sweep row, batch 2, profiled", result["sweep_row"])
    del pipe, images, attacked, latents, z_back, parts
    torch.cuda.empty_cache()

    # ---- sd-2-1-base, 512x512, batch 4
    pipe = paths.build_pipeline("sd-2-1-base")
    cfg = paths.config(paths.RES_512, "gswm_torch")
    images = paths.random_images_512()

    def chain_512(seed=2):
        paths.extraction_chain_512(pipe, cfg, images, seed)

    chain_512(1)
    result["chain_512_wall_s"] = [wall_of(chain_512) for _ in range(3)]
    print(f"512x512 extraction chain, batch 4, unprofiled: wall "
          f"{result['chain_512_wall_s']} s", flush=True)
    result["chain_512"] = profiled(chain_512, args.top)
    report("512x512 extraction chain, batch 4, profiled", result["chain_512"])
    del pipe
    torch.cuda.empty_cache()

    # ---- sdxl-base, 1024x1024, batch 2
    pipe = paths.build_pipeline("sdxl-base")
    cfg = paths.config(paths.RES_1024, "gswm_torch sdxl")
    ids = paths.prompt_ids(pipe, paths.BATCH_1024)
    result["unet_forward_1024"] = {}
    for batch in (paths.BATCH_1024, 2 * paths.BATCH_1024):
        unet_in = paths.unet_inputs(pipe, batch, res=paths.RES_1024)

        def forward_xl():
            with torch.inference_mode():
                for _ in range(3):
                    pipe.unet(*unet_in)

        forward_xl()
        res_f = profiled(forward_xl, args.top)
        report(f"1024x1024 SDXL UNet forward x3, batch {batch}", res_f)
        print(f"  device time per forward {res_f['busy_s'] / 3 * 1e3:.3f} ms, "
              f"{res_f['device_records'] / 3:.0f} device records a forward", flush=True)
        result["unet_forward_1024"][batch] = res_f
        del unet_in

    def chain_1024(seed=61):
        paths.watermark_chain(pipe, cfg, ids, seed, paths.BATCH_1024)

    chain_1024(60)
    result["chain_1024_wall_s"] = wall_of(chain_1024)
    print(f"1024x1024 SDXL chain, batch 2, unprofiled: wall "
          f"{result['chain_1024_wall_s']:.4f} s", flush=True)
    result["chain_1024"] = profiled(chain_1024, args.top)
    report("1024x1024 SDXL chain, batch 2, profiled", result["chain_1024"])
    del pipe
    torch.cuda.empty_cache()

    # ---- sd-1-4, 512x512, batch 4
    pipe = paths.build_pipeline("sd-1-4")
    cfg = paths.config(paths.RES_512, "gswm_torch sd14")
    ids = paths.prompt_ids(pipe, paths.BATCH_SD14)
    result["unet_forward_sd14"] = {}
    for batch in (paths.BATCH_SD14, 2 * paths.BATCH_SD14):
        unet_in = paths.unet_inputs(pipe, batch, res=paths.RES_512)

        def forward_sd14():
            with torch.inference_mode():
                for _ in range(3):
                    pipe.unet(*unet_in)

        forward_sd14()
        res_f = profiled(forward_sd14, args.top)
        report(f"512x512 SD 1.x UNet forward x3, batch {batch}", res_f)
        print(f"  device time per forward {res_f['busy_s'] / 3 * 1e3:.3f} ms, "
              f"{res_f['device_records'] / 3:.0f} device records a forward", flush=True)
        result["unet_forward_sd14"][batch] = res_f
        del unet_in

    def chain_sd14(seed=81):
        paths.watermark_chain(pipe, cfg, ids, seed, paths.BATCH_SD14)

    chain_sd14(80)
    result["chain_sd14_wall_s"] = wall_of(chain_sd14)
    print(f"512x512 SD 1.x chain, batch 4, unprofiled: wall "
          f"{result['chain_sd14_wall_s']:.4f} s", flush=True)
    result["chain_sd14"] = profiled(chain_sd14, args.top)
    report("512x512 SD 1.x chain, batch 4, profiled", result["chain_sd14"])
    del pipe
    torch.cuda.empty_cache()

    # ---- K8 alone: the device's time against the wrapper's
    from gswm_torch.ops import groupnorm as gn

    result["group_norm"] = []
    g = torch.Generator(device="cuda").manual_seed(8)
    for shape, act in paths.K8_PROBE_CASES:
        x = (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5).bfloat16()
        w, b = torch.ones(shape[1], device="cuda"), torch.zeros(shape[1], device="cuda")

        def call():
            gn.fused_group_norm(x, w, b, 32, 1e-5, act)

        wrapper = time_ms(call, 50)
        device = device_ms(call, 50, "gn_")
        bound, _ = roofline.bound_ms(*roofline.group_norm_cost(shape), roofline.PEAK_FP32)
        print(f"K8 {shape} {act}: wrapper {wrapper:.4f} ms a call (CUDA events), device "
              f"{device:.4f} ms a call, bound {bound:.4f} ms ({bound / device * 100:.0f}% "
              f"of the device's time)", flush=True)
        result["group_norm"].append(dict(shape=list(shape), act=act, wrapper_ms=wrapper,
                                         device_ms=device, bound_ms=bound))
        del x
    result["tracer_old"] = report_tracer("old", started)
    print(json.dumps(result))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
    sys.exit(0)
