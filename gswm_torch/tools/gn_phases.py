"""Where a block of K8's grid and slab kernels spends its time, phase by phase.

    python -m gswm_torch.tools.gn_phases [--out FILE.json] [--iters 50] [--columns]

On one card.  ``csrc/group_norm.cu`` is compiled alone with
``-DGN_PHASE_STAMPS`` into ``build/gn_phases/``: in that build thread 0 of
each block of ``gn_grid_kernel`` (float32 NCHW groups above 16 x 220 KB) and
of ``gn_slab_kernel`` (channels-last x) adds the ``clock64`` cycles of each
phase of each round (a ``__syncthreads`` before every stamp) and the bytes
of x the block loads from global memory, and the C entry
``gswm_group_norm_phases`` hands them over.  The phases of a round:

  * load: the tail read from device memory and the kept part landing in
    shared memory, both summed;
  * reduce: the block's sums (the slab kernel's per channel, then per
    group) to its place: the cluster's shared memory or the launch's
    scratch;
  * meet: the cluster barrier, or the wait at the unit's counter;
  * combine: the unit's sums added in rank order, the statistics;
  * store: the normalised tail and kept part written, the next round's
    copies issued.

For each case it prints the program build's device time a call (CUDA
events over ``--iters`` launches of the C entry), the stamped build's, the
blocks and rounds, each phase's mean and largest share of a block's cycles
and its mean cycles a block, and the bytes of x loaded from global memory a
call against x's own (1.0: every byte read once; what is read twice may come
from L2 the second time), with the card's name and power limit.  The shares
are of the stamped build, whose extra barriers cost what its time shows
beside the program's.

``--columns`` measures instead what a column of a row costs against the
whole row (the stamped build's ``gswm_column_probe``): the 768x768 VAE
image's 151 MB cut into rows of 256 and 512 bytes (bf16 rows of 128 and 256
channels), moved one column of 16, 32, 64 or 128 bytes at a time, every
column in turn (the whole tensor once), or whole rows at once; copied to the
same place of a second tensor, or read alone.  Times by CUDA events in
turns (widths up, then down), and the rate in GB/s of the bytes moved.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time
from pathlib import Path

import torch

from gswm_torch import native

PHASES = ("load", "reduce", "meet", "combine", "store")
STAMP_BLOCKS = 1024  # group_norm.cu GN_STAMP_BLOCKS
BUILD = native.BUILD_DIR.parent / "gn_phases"
# (layout, dtype, NCHW shape, act): the 768x768 VAE's largest groups at batch
# 1 and 2, and channels-last x from the VAE's largest image (the grid, a slab
# a round) through its 192x192 ones (the grid, slabs kept whole) to the
# UNet's (clusters; the smallest, 12x12)
CASES = [
    ("nchw", torch.float32, (1, 128, 768, 768), "silu"),
    ("nchw", torch.float32, (2, 256, 384, 384), "silu"),
    ("nchw", torch.float32, (2, 128, 768, 768), "silu"),
    ("nhwc", torch.bfloat16, (1, 128, 768, 768), "silu"),
    ("nhwc", torch.bfloat16, (1, 512, 192, 192), "silu"),
    ("nhwc", torch.bfloat16, (2, 512, 96, 96), "silu"),
    ("nhwc", torch.bfloat16, (2, 320, 96, 96), "silu"),
    ("nhwc", torch.bfloat16, (2, 1280, 12, 12), "silu"),
    ("nhwc", torch.float32, (1, 128, 768, 768), "silu"),
    ("nhwc", torch.float32, (2, 320, 96, 96), "silu"),
]


def build_stamped() -> ctypes.CDLL:
    """group_norm.cu with the phase stamps, as its own library."""
    BUILD.mkdir(parents=True, exist_ok=True)
    lib = BUILD / "libgn_phases.so"
    t0 = time.perf_counter()
    res = subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-DGN_PHASE_STAMPS", "-shared",
                          "-o", str(lib), str(native.CSRC / "group_norm.cu")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
    print(f"stamped build: {time.perf_counter() - t0:.1f} s", flush=True)
    out = ctypes.CDLL(str(lib))
    for name, argtypes in native._SIGNATURES.items():
        if name.startswith("gswm_group_norm"):
            getattr(out, name).argtypes = argtypes
            getattr(out, name).restype = ctypes.c_int
    out.gswm_group_norm_phases.argtypes = [ctypes.c_void_p]
    out.gswm_group_norm_phases.restype = ctypes.c_int
    out.gswm_column_probe.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
    out.gswm_column_probe.restype = ctypes.c_int
    out.gswm_slab_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    out.gswm_slab_plan.restype = ctypes.c_int
    return out


PLAN_FIELDS = ("cluster", "groups_a_slab", "units", "units_a_round", "blocks_a_unit",
               "pixels_a_slice", "kept_pixels", "evict_last_steps")


def slab_plan(stamped, shape, groups: int, dtype) -> dict:
    """The slab kernel's plan for channels-last x of ``shape``
    (``gswm_slab_plan``: cluster or grid, the slab, K, P, the slices)."""
    plan = (ctypes.c_int * (len(PLAN_FIELDS) + 16))()
    _check(stamped.gswm_slab_plan(shape[0], shape[1], shape[2] * shape[3], groups,
                                  int(dtype == torch.float32), plan), "slab plan")
    return dict(zip(PLAN_FIELDS, plan))


def _events_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def phases(stamped, layout, dtype, shape, act, iters: int) -> dict:
    """One case: both builds' times, then one stamped launch's phases."""
    g = torch.Generator(device="cuda").manual_seed(shape[1] + shape[2])
    x = (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5).to(dtype)
    if layout == "nhwc":
        x = x.contiguous(memory_format=torch.channels_last)
    w = 1 + 0.05 * torch.randn(shape[1], generator=g, device="cuda")
    b = 0.05 * torch.randn(shape[1], generator=g, device="cuda")
    out = torch.empty_like(x)
    entry = "gswm_group_norm" + ("_nhwc" if layout == "nhwc" else "") + \
        ("_f32" if dtype == torch.float32 else "")
    hw = shape[2] * shape[3]
    stream = native.stream_handle(x.device)
    args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), shape[0], shape[1], hw,
            32, 1e-6, 1 if act == "silu" else 0, stream)
    lib = native.library()
    ms = _events_ms(lambda: lib.call(entry, *args), iters)
    stamped_ms = _events_ms(lambda: _check(getattr(stamped, entry)(*args), entry), iters)
    stamps = torch.zeros((STAMP_BLOCKS, len(PHASES) + 3), dtype=torch.int64)
    _check(stamped.gswm_group_norm_phases(ctypes.c_void_p(stamps.data_ptr())), "phases")
    _check(getattr(stamped, entry)(*args), entry)
    torch.cuda.synchronize()
    _check(stamped.gswm_group_norm_phases(ctypes.c_void_p(stamps.data_ptr())), "phases")
    plan = slab_plan(stamped, shape, 32, dtype) if layout == "nhwc" else None
    rows = stamps[stamps[:, len(PHASES)] > 0].double()
    total = rows[:, len(PHASES)]
    share = rows[:, :len(PHASES)] / total[:, None]
    loaded = rows[:, len(PHASES) + 2].sum().item()
    res = dict(layout=layout, dtype=str(dtype).replace("torch.", ""), shape=list(shape), act=act,
               ms=ms, stamped_ms=stamped_ms, blocks=int(rows.shape[0]),
               rounds=[int(rows[:, len(PHASES) + 1].min()), int(rows[:, len(PHASES) + 1].max())],
               bytes_loaded=loaded, reads=loaded / (x.numel() * x.element_size()), plan=plan,
               block_cycles=total.mean().item(),
               phases={name: dict(share=share[:, k].mean().item(),
                                  share_max=share[:, k].max().item(),
                                  cycles=rows[:, k].mean().item())
                       for k, name in enumerate(PHASES)})
    text = ", ".join(f"{name} {v['share']:.1%} (max {v['share_max']:.1%}, "
                     f"{v['cycles']:.0f} cycles)" for name, v in res["phases"].items())
    how = "" if plan is None else (
        f"{'clusters' if plan['cluster'] else 'grid'} of {plan['blocks_a_unit']} blocks a slab "
        f"of {plan['groups_a_slab']} groups ({plan['groups_a_slab'] * shape[1] // 32 * x.element_size()}"
        f" bytes a pixel), {plan['units_a_round']} of {plan['units']} slabs a round; ")
    print(f"{layout} {res['dtype']} {tuple(shape)} {act}: {how}{ms:.4f} ms a call (stamped "
          f"{stamped_ms:.4f}); {res['blocks']} blocks, rounds {res['rounds']}; x loaded "
          f"{res['reads']:.3f} times ({loaded / 1e6:.1f} MB); a block "
          f"{res['block_cycles']:.0f} cycles: {text}", flush=True)
    return res


COLUMN_TENSOR_BYTES = 768 * 768 * 128 * 2
COLUMN_ROWS = (256, 512)
COLUMN_WIDTHS = (16, 32, 64, 128)


def columns(stamped, iters: int) -> list:
    """The column probe: for each row width and mode, each column width's
    time to move the whole tensor, in turns."""
    x = torch.randint(0, 255, (COLUMN_TENSOR_BYTES,), dtype=torch.uint8, device="cuda")
    out = torch.empty_like(x)
    stream = native.stream_handle(x.device)
    res = []
    for row in COLUMN_ROWS:
        rows = COLUMN_TENSOR_BYTES // row
        widths = (*(w for w in COLUMN_WIDTHS if w < row), row)
        for mode, name in ((0, "copy"), (1, "read")):
            def run(w, mode=mode, row=row, rows=rows):
                for off in range(0, row, w):
                    _check(stamped.gswm_column_probe(x.data_ptr(), out.data_ptr(), rows, row,
                                                     w, off, mode, stream), "column probe")
            times = {w: [] for w in widths}
            for w in (*widths, *reversed(widths)):
                times[w].append(_events_ms(lambda w=w: run(w), iters))
            moved = COLUMN_TENSOR_BYTES * (2 if mode == 0 else 1)
            for w in widths:
                best = min(times[w])
                res.append(dict(row_bytes=row, column_bytes=w, mode=name, ms=times[w],
                                gb_s=moved / best / 1e6))
                print(f"columns: {name} {w}-byte columns of {row}-byte rows, "
                      f"{COLUMN_TENSOR_BYTES / 1e6:.1f} MB: {times[w]} ms, "
                      f"{moved / best / 1e6:.0f} GB/s", flush=True)
    return res


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="write the cases as JSON here")
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--columns", action="store_true",
                        help="measure column reads and copies instead of the phases")
    args = parser.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    stamped = build_stamped()
    if args.columns:
        result = dict(card=card.strip(), columns=columns(stamped, args.iters))
    else:
        result = dict(card=card.strip(),
                      cases=[phases(stamped, *case, args.iters) for case in CASES])
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
