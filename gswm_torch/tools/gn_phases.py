"""Where a block of K8's persistent grid spends its time, phase by phase.

    python -m gswm_torch.tools.gn_phases [--out FILE.json] [--iters 50]

On one card.  ``csrc/group_norm.cu`` is compiled alone with
``-DGN_PHASE_STAMPS`` into ``build/gn_phases/``: in that build thread 0 of
each block of ``gn_grid_kernel`` adds the ``clock64`` cycles of each phase of
each round (a ``__syncthreads`` before every stamp) and the C entry
``gswm_group_norm_phases`` hands them over.  The phases of a round:

  * load: the tail read from device memory and the kept head landing in
    shared memory, both summed;
  * reduce: the block's sums written to its place in the launch's scratch;
  * meet: the wait at the unit's arrival counter;
  * combine: the unit's sums added in rank order, the statistics;
  * store: the normalised tail and head written, the next round's copies
    issued.

For each case (the grid's shapes: float32 NCHW groups above 16 x 220 KB and
channels-last x) it prints the program build's device time a call (CUDA
events over ``--iters`` launches of the C entry), the stamped build's, the
grid's blocks and rounds, and each phase's mean and largest share of a
block's cycles and its mean cycles a block, with the card's name and power
limit.  The shares are of the stamped build, whose extra barriers cost what
its time shows beside the program's.
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
# 1 and 2, and channels-last x from the VAE's largest image to the UNet's
CASES = [
    ("nchw", torch.float32, (1, 128, 768, 768), "silu"),
    ("nchw", torch.float32, (2, 256, 384, 384), "silu"),
    ("nchw", torch.float32, (2, 128, 768, 768), "silu"),
    ("nhwc", torch.bfloat16, (1, 128, 768, 768), "silu"),
    ("nhwc", torch.bfloat16, (2, 512, 96, 96), "silu"),
    ("nhwc", torch.bfloat16, (2, 320, 96, 96), "silu"),
    ("nhwc", torch.float32, (1, 128, 768, 768), "silu"),
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
    return out


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
    stamps = torch.zeros((STAMP_BLOCKS, len(PHASES) + 2), dtype=torch.int64)
    _check(stamped.gswm_group_norm_phases(ctypes.c_void_p(stamps.data_ptr())), "phases")
    _check(getattr(stamped, entry)(*args), entry)
    torch.cuda.synchronize()
    _check(stamped.gswm_group_norm_phases(ctypes.c_void_p(stamps.data_ptr())), "phases")
    rows = stamps[stamps[:, len(PHASES)] > 0].double()
    total = rows[:, len(PHASES)]
    share = rows[:, :len(PHASES)] / total[:, None]
    res = dict(layout=layout, dtype=str(dtype).replace("torch.", ""), shape=list(shape), act=act,
               ms=ms, stamped_ms=stamped_ms, blocks=int(rows.shape[0]),
               rounds=[int(rows[:, -1].min()), int(rows[:, -1].max())],
               block_cycles=total.mean().item(),
               phases={name: dict(share=share[:, k].mean().item(),
                                  share_max=share[:, k].max().item(),
                                  cycles=rows[:, k].mean().item())
                       for k, name in enumerate(PHASES)})
    text = ", ".join(f"{name} {v['share']:.1%} (max {v['share_max']:.1%}, "
                     f"{v['cycles']:.0f} cycles)" for name, v in res["phases"].items())
    print(f"{layout} {res['dtype']} {tuple(shape)} {act}: {ms:.4f} ms a call (stamped "
          f"{stamped_ms:.4f}); {res['blocks']} blocks, rounds {res['rounds']}; a block "
          f"{res['block_cycles']:.0f} cycles: {text}", flush=True)
    return res


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="write the cases as JSON here")
    parser.add_argument("--iters", type=int, default=50)
    args = parser.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    stamped = build_stamped()
    cases = [phases(stamped, *case, args.iters) for case in CASES]
    if args.out:
        Path(args.out).write_text(json.dumps(dict(card=card.strip(), cases=cases), indent=1))


if __name__ == "__main__":
    main()
