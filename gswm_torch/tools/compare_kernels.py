"""Time this checkout's kernels against another checkout's, in turns, on one
card.

    python -m gswm_torch.tools.compare_kernels --parent DIR [--out FILE.json]
        [--cases attention,k8,k3] [--match TEXT]

DIR is a second checkout of the repository (for example ``git archive`` of
the parent commit unpacked into a git-ignored directory).  Both kernel
libraries are built (each in its own ``build/``) and called through their C
entry points on the same tensors, so nothing but the kernels differs:

  * flash attention at every shape ``chip_smoke.py`` phase 2 gives it whose
    head dim is at most 64 or a multiple of 64: D <= 64 (natural layout, K2
    at D = 40 and flash_hopper.cu's narrow kernel among them, K1's core, the
    split wrapper's ragged shape, packed), the split layout from D = 128 up
    (K4), and the transposed layout (K7), whose ``gswm_flash_transposed``
    each side is called with the arguments its library declares (the head
    dim since K7 takes any, none before: such a side is timed at D = 64
    alone); CUDA-event times in the order parent, change, change, parent;
  * fused-qkv self-attention (GEMM + core) at K1's shapes of those widths,
    likewise, and the device time of each side's ``qkv_proj_kernel`` alone
    from ``torch.profiler``; each side's ``gswm_fused_qkv_attn`` is called
    with the arguments its library declares (the head dim since SD 1.x's
    kernels, none before: 64);
  * the host time of one launcher call (tensor-map encoding included) on a
    one-tile shape, where the device never holds the host back;
  * GroupNorm (K8) and ChaCha20 (K3) through each side's own wrappers, host
    side included (their C signatures may differ between the checkouts): K8
    at every GroupNorm shape of the 768x768 path, summed, and at
    ``paths.K8_PROBE_CASES`` with the device time beside; K3's single-key
    keystream at 32 blocks and 2^20, and the many-key keystream bits at
    ``paths.K3_BATCH_SHAPES``, where a side without ``batch_keystream_bits``
    takes what its callers had: ``keystream_bits`` row by row.

``--match`` keeps only the attention cases whose label holds TEXT (say
``"K2 (4, 4096, 8, "`` for K2 at SD 1.x's level 0 and the narrow widths).
``--require-equal`` fails unless every attention case's two outputs are
equal bit for bit (a change that must leave the kernels' results alone).
Prints a line per case and, last, one JSON object; ``--out`` also writes it.
"""

from __future__ import annotations

import argparse
import importlib
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
FLASH_SHAPES = tuple(case for case in (  # (label, B, Sq, Sk, H, D)
    *((f"K2 ({b}, {s}, {h}, {d})", b, s, s, h, d) for b, s, h, d in paths.K2_SHAPES),
    *((f"K4 ({b}, {s}, {h}, {d})", b, s, s, h, d) for b, s, h, d in paths.K4_SHAPES),
    *((f"K1 core ({b}, {s}, {h}, {d})", b, s, s, h, d)
      for b, s, _, h, d in paths.K1_SHAPES)) if case[-1] <= 64 or case[-1] % 64 == 0)
PACKED_SHAPES = tuple((b, s, paths.pairs_of(h))  # (B, S, P)
                      for b, s, h in paths.LEVEL0_SHAPES)
TRANSPOSED_SHAPES = paths.K7_SHAPES  # (B, S, H, D)
K1_SHAPES = tuple(shape for shape in paths.K1_SHAPES if shape[-1] == 64)  # (B, S, C, H, D)


def load_parent(root: Path):
    """The other checkout's kernel library, through its own native.py, and
    its ``ops.groupnorm`` and ``core.chacha`` modules: its package is
    imported under the package's own name while this checkout's modules are
    set aside, then the two are swapped back."""
    def ours():
        return [k for k in sys.modules if k == "gswm_torch" or k.startswith("gswm_torch.")]

    mine = {k: sys.modules.pop(k) for k in ours()}
    sys.path.insert(0, str(root))
    try:
        native_mod = importlib.import_module("gswm_torch.native")
        gn = importlib.import_module("gswm_torch.ops.groupnorm")
        chacha = importlib.import_module("gswm_torch.core.chacha")
        if Path(native_mod.__file__).resolve().parent.parent != root:
            raise RuntimeError(f"{root} holds no gswm_torch package")
    finally:
        sys.path.remove(str(root))
        for k in ours():
            del sys.modules[k]
        sys.modules.update(mine)
    return native_mod.library(), gn, chacha


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
    """Device time per call of the kernels whose name holds ``name_part``.
    The calls stand well inside the profiler's window, which drops a device
    event that its clock mapping puts a moment outside."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    # per kernel name, its mean time by the events that were kept, times its
    # launches a call: the profiler drops some events, so their count, not
    # iters, divides the sum
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" and name_part in e.key
              and e.self_device_time_total > 0]
    if not events:
        raise RuntimeError(f"the profiler saw no device time for {name_part}")
    return sum(e.self_device_time_total / e.count * max(1, round(e.count / iters))
               for e in events) / 1e3


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


def _sides_ms(fns: dict, iters: int) -> dict:
    t = in_turns(fns, iters)
    t["ratio"] = sum(t["parent"]) / sum(t["change"])
    return t


def compare_group_norm(parent_gn, iters: int) -> dict:
    """K8 through each side's wrapper, fp32 parameters on the card: every
    GroupNorm shape of the 768x768 path (the sum is per round), then the
    probe cases with each side's device time."""
    from gswm_torch.ops import groupnorm as gn

    sides = {"parent": parent_gn.fused_group_norm, "change": gn.fused_group_norm}
    pipe = paths.build_pipeline("sd-2-1")
    gn_cases = paths.groupnorm_cases(pipe)
    del pipe
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(8)
    out = {"cases": [], "probes": []}
    sums = {"parent": [0.0, 0.0], "change": [0.0, 0.0]}
    bound_sum = 0.0
    for shape, eps, act in gn_cases:
        x = (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5).bfloat16()
        w = 1 + 0.05 * torch.randn(shape[1], generator=g, device="cuda")
        b = 0.05 * torch.randn(shape[1], generator=g, device="cuda")
        t = _sides_ms({side: (lambda fn=fn: fn(x, w, b, 32, eps, act))
                       for side, fn in sides.items()}, iters)
        diff = (sides["parent"](x, w, b, 32, eps, act).float()
                - sides["change"](x, w, b, 32, eps, act).float()).abs().max().item()
        bound, _ = roofline.bound_ms(*roofline.group_norm_cost(shape), roofline.PEAK_FP32)
        bound_sum += bound
        for side in sums:
            sums[side] = [a + c for a, c in zip(sums[side], t[side])]
        print(f"K8 {shape} {act}: parent {t['parent']} change {t['change']} ms, "
              f"{t['ratio']:.2f}x, bound {bound:.4f} ms, max|parent - change| {diff:.5f}",
              flush=True)
        out["cases"].append(dict(shape=list(shape), eps=eps, act=act, **t,
                                 bound_ms=bound, max_abs_diff=diff))
        del x
    out["sum"] = dict(**sums, ratio=sum(sums["parent"]) / sum(sums["change"]),
                      bound_ms=bound_sum, shapes=len(gn_cases))
    print(f"K8 {len(gn_cases)} shapes summed: parent {sums['parent']} change "
          f"{sums['change']} ms, {out['sum']['ratio']:.2f}x, bound {bound_sum:.4f} ms",
          flush=True)
    for shape, act in paths.K8_PROBE_CASES:
        x = (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5).bfloat16()
        w, b = torch.ones(shape[1], device="cuda"), torch.zeros(shape[1], device="cuda")
        fns = {side: (lambda fn=fn: fn(x, w, b, 32, 1e-5, act))
               for side, fn in sides.items()}
        t = _sides_ms(fns, 50)
        device = {side: [] for side in sides}
        for side in ROUNDS:
            device[side].append(device_ms(fns[side], 50, "gn_"))
        bound, _ = roofline.bound_ms(*roofline.group_norm_cost(shape), roofline.PEAK_FP32)
        # what a plain copy of x takes: the same bytes read and written
        y = torch.empty_like(x)
        copy = time_ms(lambda: y.copy_(x), 50)
        print(f"K8 probe {shape} {act}: wrapper parent {t['parent']} change "
              f"{t['change']} ms, {t['ratio']:.2f}x; device parent {device['parent']} "
              f"change {device['change']} ms; bound {bound:.4f} ms; Tensor.copy_ of x "
              f"{copy:.4f} ms", flush=True)
        out["probes"].append(dict(shape=list(shape), act=act, **t, device_ms=device,
                                  bound_ms=bound, copy_ms=copy))
        del y
        del x
    return out


def compare_chacha(parent_chacha, iters: int) -> dict:
    """K3 through each side's wrappers: one key, and a table of keys."""
    from gswm_torch.core import chacha

    sides = {"parent": parent_chacha, "change": chacha}
    key, nonce = bytes.fromhex(paths.KEY_HEX), bytes.fromhex(paths.NONCE_HEX)
    out = {"single": [], "batch": []}
    for n_blocks in (32, 2**20):
        fns = {side: (lambda m=m: m.keystream_words(key, nonce, n_blocks, "cuda"))
               for side, m in sides.items()}
        t = _sides_ms(fns, iters)
        bound, _ = roofline.bound_ms(*roofline.chacha_cost(n_blocks), roofline.PEAK_INT32)
        print(f"K3 one key, {n_blocks} blocks: parent {t['parent']} change {t['change']} "
              f"ms, {t['ratio']:.2f}x, bound {bound:.6f} ms", flush=True)
        out["single"].append(dict(n_blocks=n_blocks, **t, bound_ms=bound))
    for rows, n_blocks in paths.K3_BATCH_SHAPES:
        n_bits = n_blocks * chacha.BLOCK_BITS
        keys, nonces, _, _ = paths.multikey_material(rows, seed=rows)

        def row_by_row(m):
            return torch.stack([m.keystream_bits(k, n, n_bits, "cuda")
                                for k, n in zip(keys, nonces)])

        fns = {side: ((lambda m=m: m.batch_keystream_bits(keys, nonces, n_bits, "cuda"))
                      if hasattr(m, "batch_keystream_bits") else (lambda m=m: row_by_row(m)))
               for side, m in sides.items()}
        how = {side: "one launch" if hasattr(m, "batch_keystream_bits") else "row by row"
               for side, m in sides.items()}
        same = torch.equal(fns["parent"](), fns["change"]())
        # a side that loops over the rows takes seconds a call at 10,000 rows
        t = _sides_ms(fns, iters if rows <= 64 else 2)
        bound, _ = roofline.bound_ms(*roofline.chacha_batch_cost(rows, n_bits),
                                     roofline.PEAK_INT32)
        device = device_ms(fns["change"], 10, "chacha20_batch")
        # what filling the output takes: the same bytes written
        bits = torch.empty((rows, n_bits), dtype=torch.uint8, device="cuda")
        fill = time_ms(lambda: bits.fill_(1), 50)
        print(f"K3 {rows} keys x {n_blocks} blocks, bits out: parent ({how['parent']}) "
              f"{t['parent']} change ({how['change']}) {t['change']} ms, "
              f"{t['ratio']:.1f}x, on the device {device:.4f} ms, bound {bound:.6f} ms, "
              f"Tensor.fill_ of the output {fill:.4f} ms, equal bits {same}", flush=True)
        if not same:
            raise AssertionError(f"K3 over {rows} keys: the two sides' bits differ")
        out["batch"].append(dict(rows=rows, n_blocks=n_blocks, how=how, **t,
                                 device_ms=device, bound_ms=bound, fill_ms=fill))
        del bits
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cases", default="attention,k8,k3",
                    help="which of attention, k8, k3 to time (comma-separated)")
    ap.add_argument("--match", default="",
                    help="time only the attention cases whose label holds this")
    ap.add_argument("--require-equal", action="store_true",
                    help="fail unless every attention output equals the parent's")
    args = ap.parse_args()
    cases = set(args.cases.split(","))
    if not cases or cases - {"attention", "k8", "k3"}:
        raise SystemExit(f"compare_kernels: unknown cases {args.cases!r}")
    if not torch.cuda.is_available():
        raise SystemExit("compare_kernels: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    parent_lib, parent_gn, parent_chacha = load_parent(args.parent.resolve())
    libs = {"parent": parent_lib, "change": native.library()}
    dev = torch.device("cuda")
    stream = native.stream_handle(dev)
    g = torch.Generator(device=dev).manual_seed(4)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).bfloat16()

    result = {"card": card, "rounds": list(ROUNDS)}
    if "k8" in cases:
        result["group_norm"] = compare_group_norm(parent_gn, args.iters)
    if "k3" in cases:
        result["chacha"] = compare_chacha(parent_chacha, args.iters)
    if "attention" in cases:
        result.update(compare_attention(libs, rand, stream, args.iters, args.match))
    print(json.dumps(result))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    if args.require_equal:
        differ = [case for key in ("flash", "packed", "transposed", "fused_qkv")
                  for case in result.get(key, []) if case["max_abs_diff"] != 0.0]
        if differ:
            raise SystemExit(f"compare_kernels: {len(differ)} attention cases differ from "
                             f"the parent's: {[c.get('label', c['shape']) for c in differ]}")
        print("every attention output equals the parent's, bit for bit", flush=True)


def compare_attention(libs: dict, rand, stream: int, iters: int, match: str = "") -> dict:
    """The flash kernels and K1's GEMM through their C entry points; only
    the cases whose label holds ``match``."""
    result = {"flash": [], "packed": [], "transposed": [], "fused_qkv": [],
              "host_us": {}}
    for label, b, sq, sk, h, d in FLASH_SHAPES:
        if match not in label:
            continue
        q, k, v = rand(b, sq, h, d), rand(b, sk, h, d), rand(b, sk, h, d)
        outs = {side: torch.empty_like(q) for side in libs}
        fns = {side: (lambda side=side: libs[side].call(
            "gswm_flash_split", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            outs[side].data_ptr(), b, sq, sk, h, d, stream)) for side in libs}
        t = in_turns(fns, iters)
        diff = (outs["parent"].float() - outs["change"].float()).abs().max().item()
        bound, roof = roofline.attention_bound_ms(roofline.attention_cost(b, sq, sk, h, d))
        ratio = sum(t["parent"]) / sum(t["change"])
        print(f"flash {label}: parent {t['parent']} change {t['change']} ms, "
              f"{ratio:.2f}x, bound {bound:.4f} ms by {roof}, max|parent - change| "
              f"{diff:.5f}", flush=True)
        result["flash"].append(dict(label=label, shape=[b, sq, sk, h, d], **t,
                                    ratio=ratio, bound_ms=bound, roof=roof,
                                    max_abs_diff=diff))
    for b, s, pairs in PACKED_SHAPES:
        if match not in f"packed (B={b}, S={s}, P={pairs})":
            continue
        qkv = rand(b, s, 3 * pairs * 128)
        outs = {side: qkv.new_empty((b, s, pairs * 128)) for side in libs}
        fns = {side: (lambda side=side: libs[side].call(
            "gswm_flash_packed", qkv.data_ptr(), outs[side].data_ptr(), b, s, pairs,
            stream)) for side in libs}
        t = in_turns(fns, iters)
        diff = (outs["parent"].float() - outs["change"].float()).abs().max().item()
        ratio = sum(t["parent"]) / sum(t["change"])
        print(f"packed (B={b}, S={s}, P={pairs}): parent {t['parent']} change "
              f"{t['change']} ms, {ratio:.2f}x, max|parent - change| {diff:.5f}",
              flush=True)
        result["packed"].append(dict(shape=[b, s, pairs], **t, ratio=ratio,
                                     max_abs_diff=diff))
    # (B, S, H[, D]): a library built before K7 took the head dim declares
    # one int fewer and takes D = 64 alone
    takes_d = {side: len(libs[side].lib.gswm_flash_transposed.argtypes) == 7
               for side in libs}
    for b, s, h, d in TRANSPOSED_SHAPES:
        if match not in f"transposed (B={b}, S={s}, H={h}, D={d})":
            continue
        if d != 64 and not all(takes_d.values()):
            print(f"transposed (B={b}, S={s}, H={h}, D={d}): skipped, a side takes "
                  "D = 64 alone", flush=True)
            continue
        qkv_t = rand(3 * h * d, b, s)
        outs = {side: qkv_t.new_empty((h * d, b, s)) for side in libs}
        fns = {side: (lambda side=side: libs[side].call(
            "gswm_flash_transposed", qkv_t.data_ptr(), outs[side].data_ptr(), b, s, h,
            *((d,) if takes_d[side] else ()), stream)) for side in libs}
        t = in_turns(fns, iters)
        diff = (outs["parent"].float() - outs["change"].float()).abs().max().item()
        bound, roof = roofline.attention_bound_ms(roofline.attention_cost(b, s, s, h, d))
        ratio = sum(t["parent"]) / sum(t["change"])
        print(f"transposed (B={b}, S={s}, H={h}, D={d}): parent {t['parent']} change "
              f"{t['change']} ms, {ratio:.2f}x, bound {bound:.4f} ms by {roof}, "
              f"max|parent - change| {diff:.5f}", flush=True)
        result["transposed"].append(dict(shape=[b, s, h, d], **t, ratio=ratio,
                                         bound_ms=bound, roof=roof, max_abs_diff=diff))
    for b, s, c, h, d in K1_SHAPES:
        if match not in f"fused_qkv (B={b}, S={s}, C={c}, H={h})":
            continue
        n = h * d
        x = rand(b, s, c)
        ws = [rand(n, c, scale=c**-0.5) for _ in range(3)]
        bufs = {side: [x.new_empty((b, s, n)) for _ in range(4)] for side in libs}
        # (B, S, C, H[, D]): a library built before the head dim was an
        # argument declares one int fewer
        dims = {side: (b, s, c, h, d)[:len(libs[side].lib.gswm_fused_qkv_attn.argtypes) - 9]
                for side in libs}
        fns = {side: (lambda side=side: libs[side].call(
            "gswm_fused_qkv_attn", x.data_ptr(), *(w.data_ptr() for w in ws),
            *(t.data_ptr() for t in bufs[side]), *dims[side], stream)) for side in libs}
        t = in_turns(fns, iters)
        gemm = {side: [] for side in libs}
        for side in ROUNDS:
            gemm[side].append(device_ms(fns[side], iters, "qkv_proj_kernel"))
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
    return result


if __name__ == "__main__":
    main()
    sys.exit(0)
