"""Time this checkout's attention kernels and projection GEMM against another
checkout's, in turns, on one card.

    python -m gswm_torch.tools.compare_kernels --parent DIR [--out FILE.json]

DIR is a second checkout of the repository (for example ``git archive`` of
the parent commit unpacked into a git-ignored directory).  Both kernel
libraries are built (each in its own ``build/``) and called through their C
entry points on the same tensors, so nothing but the kernels differs:

  * flash attention at every shape ``chip_smoke.py`` phase 2 gives it: D = 64
    (natural layout, K1's core, the split wrapper's ragged shape, packed),
    the split layout from D = 128 up (K4), and the transposed layout (K7);
    CUDA-event times in the order parent, change, change, parent;
  * fused-qkv self-attention (GEMM + core) at K1's four shapes, likewise,
    and the device time of each side's ``qkv_proj_kernel`` alone from
    ``torch.profiler``;
  * the host time of one launcher call (tensor-map encoding included) on a
    one-tile shape, where the device never holds the host back.

Prints a line per case and, last, one JSON object; ``--out`` also writes it.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from gswm_torch import native, roofline
from gswm_torch.tools import paths

ROUNDS = ("parent", "change", "change", "parent")
# the shapes of chip_smoke.py's phase 2 (gswm_torch/tools/paths.py)
FLASH_SHAPES = (  # (label, B, Sq, Sk, H, D)
    *((f"K2 ({b}, {s}, {h})", b, s, s, h, 64) for b, s, h in paths.K2_SHAPES),
    *((f"K4 ({b}, {s}, {h}, {d})", b, s, s, h, d) for b, s, h, d in paths.K4_SHAPES),
    *((f"K1 core ({b}, {s}, {h})", b, s, s, h, 64) for b, s, _, h in paths.K1_SHAPES))
PACKED_SHAPES = tuple((b, s, paths.pairs_of(h))  # (B, S, P)
                      for b, s, h in paths.LEVEL0_SHAPES)
TRANSPOSED_SHAPES = paths.K7_SHAPES  # (B, S, H)
K1_SHAPES = paths.K1_SHAPES  # (B, S, C, H)


def load_parent(root: Path):
    """The other checkout's kernel library, through its own native.py."""
    spec = importlib.util.spec_from_file_location(
        "gswm_torch_parent_native", root / "gswm_torch" / "native.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.library()


def time_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def in_turns(fns: dict, iters: int) -> dict:
    """{"parent": [ms, ms], "change": [ms, ms]} in the order of ROUNDS."""
    out = {"parent": [], "change": []}
    for side in ROUNDS:
        out[side].append(time_ms(fns[side], iters))
    return out


def device_ms(fn, iters: int, name_part: str) -> float:
    """Device time per call of the kernels whose name holds ``name_part``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type.name == "CUDA" and name_part in e.key)
    if total <= 0:
        raise RuntimeError(f"the profiler saw no device time for {name_part}")
    return total / 1e3 / iters


def host_us(fn, calls: int = 2000) -> float:
    """Host time of one call, the device never behind by more than a few
    one-tile kernels."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_kernels: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    libs = {"parent": load_parent(args.parent.resolve()), "change": native.library()}
    dev = torch.device("cuda")
    stream = native.stream_handle(dev)
    g = torch.Generator(device=dev).manual_seed(4)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).bfloat16()

    result = {"card": card, "rounds": list(ROUNDS), "flash": [], "packed": [],
              "transposed": [], "fused_qkv": [], "host_us": {}}
    for label, b, sq, sk, h, d in FLASH_SHAPES:
        q, k, v = rand(b, sq, h, d), rand(b, sk, h, d), rand(b, sk, h, d)
        outs = {side: torch.empty_like(q) for side in libs}
        fns = {side: (lambda side=side: libs[side].call(
            "gswm_flash_split", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            outs[side].data_ptr(), b, sq, sk, h, d, stream)) for side in libs}
        t = in_turns(fns, args.iters)
        diff = (outs["parent"].float() - outs["change"].float()).abs().max().item()
        bound, _ = roofline.bound_ms(*roofline.attention_cost(b, sq, sk, h, d),
                                     roofline.PEAK_BF16)
        ratio = sum(t["parent"]) / sum(t["change"])
        print(f"flash {label}: parent {t['parent']} change {t['change']} ms, "
              f"{ratio:.2f}x, bound {bound:.4f} ms, max|parent - change| {diff:.5f}",
              flush=True)
        result["flash"].append(dict(label=label, shape=[b, sq, sk, h, d], **t,
                                    ratio=ratio, bound_ms=bound, max_abs_diff=diff))
    for b, s, pairs in PACKED_SHAPES:
        qkv = rand(b, s, 3 * pairs * 128)
        outs = {side: qkv.new_empty((b, s, pairs * 128)) for side in libs}
        fns = {side: (lambda side=side: libs[side].call(
            "gswm_flash_packed", qkv.data_ptr(), outs[side].data_ptr(), b, s, pairs,
            stream)) for side in libs}
        t = in_turns(fns, args.iters)
        diff = (outs["parent"].float() - outs["change"].float()).abs().max().item()
        ratio = sum(t["parent"]) / sum(t["change"])
        print(f"packed (B={b}, S={s}, P={pairs}): parent {t['parent']} change "
              f"{t['change']} ms, {ratio:.2f}x, max|parent - change| {diff:.5f}",
              flush=True)
        result["packed"].append(dict(shape=[b, s, pairs], **t, ratio=ratio,
                                     max_abs_diff=diff))
    for b, s, h in TRANSPOSED_SHAPES:
        qkv_t = rand(3 * h * 64, b, s)
        outs = {side: qkv_t.new_empty((h * 64, b, s)) for side in libs}
        fns = {side: (lambda side=side: libs[side].call(
            "gswm_flash_transposed", qkv_t.data_ptr(), outs[side].data_ptr(), b, s, h,
            stream)) for side in libs}
        t = in_turns(fns, args.iters)
        diff = (outs["parent"].float() - outs["change"].float()).abs().max().item()
        bound, _ = roofline.bound_ms(*roofline.attention_cost(b, s, s, h, 64),
                                     roofline.PEAK_BF16)
        ratio = sum(t["parent"]) / sum(t["change"])
        print(f"transposed (B={b}, S={s}, H={h}): parent {t['parent']} change "
              f"{t['change']} ms, {ratio:.2f}x, bound {bound:.4f} ms, "
              f"max|parent - change| {diff:.5f}", flush=True)
        result["transposed"].append(dict(shape=[b, s, h], **t, ratio=ratio,
                                         bound_ms=bound, max_abs_diff=diff))
    for b, s, c, h in K1_SHAPES:
        n = h * 64
        x = rand(b, s, c)
        ws = [rand(n, c, scale=c**-0.5) for _ in range(3)]
        bufs = {side: [x.new_empty((b, s, n)) for _ in range(4)] for side in libs}
        fns = {side: (lambda side=side: libs[side].call(
            "gswm_fused_qkv_attn", x.data_ptr(), *(w.data_ptr() for w in ws),
            *(t.data_ptr() for t in bufs[side]), b, s, c, h, stream)) for side in libs}
        t = in_turns(fns, args.iters)
        gemm = {side: [] for side in libs}
        for side in ROUNDS:
            gemm[side].append(device_ms(fns[side], args.iters, "qkv_proj_kernel"))
        diff = (bufs["parent"][3].float() - bufs["change"][3].float()).abs().max().item()
        bound, _ = roofline.bound_ms(*roofline.projection_cost(b * s, c, n),
                                     roofline.PEAK_BF16)
        print(f"fused_qkv (B={b}, S={s}, C={c}, H={h}): parent {t['parent']} change "
              f"{t['change']} ms; GEMM alone, device: parent {gemm['parent']} change "
              f"{gemm['change']} ms, bound {bound:.4f} ms; max|parent - change| "
              f"{diff:.5f}", flush=True)
        result["fused_qkv"].append(dict(
            shape=[b, s, c, h], **t, gemm_device_ms=gemm, gemm_bound_ms=bound,
            max_abs_diff=diff))
    # one 64-row, one 128-key tile: the launcher's host time
    q, k, v = (rand(1, 64, 1, 64) for _ in range(3))
    out = torch.empty_like(q)
    for side in ROUNDS:
        us = host_us(lambda side=side: libs[side].call(
            "gswm_flash_split", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            1, 64, 64, 1, 64, stream))
        result["host_us"].setdefault(side, []).append(us)
    print(f"host time per flash launcher call, us: {result['host_us']}", flush=True)
    print(json.dumps(result))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
    sys.exit(0)
