"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (Hopper), one
``nvcc`` process per source, all started together, and the objects are
linked into ONE shared library with a plain C interface, at first use, in
``build/gswm_torch_kernels/`` at the root of the checkout; ``ctypes`` loads
it.  The library's file name carries a hash of the sources and flags, so an
edited source builds anew and an unchanged one is reused.  Nothing here runs
at import: the CPU tests import every module on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "gswm_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argtypes; every entry returns the cudaError_t of its launches.
_SIGNATURES = {
    # words12 (host uint32[12]), out, n_blocks, stream
    "gswm_chacha20_words": [_VP, _VP, _I, _VP],
    # table (device uint32[rows][12]), out (device bytes), rows, n_bits, stream
    "gswm_chacha20_batch": [_VP, _VP, _I, _I, _VP],
    # x, wq, wk, wv, q, k, v, M, C, N, stream
    "gswm_qkv_proj": [_VP] * 7 + [_I, _I, _I, _VP],
    # x, wq, wk, wv, q, k, v, out, B, S, C, H, D (head dim), stream
    "gswm_fused_qkv_attn": [_VP] * 8 + [_I, _I, _I, _I, _I, _VP],
    # q, k, v, out, B, Sq, Sk, H, D, stream
    "gswm_flash_split": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP],
    # q, k, v, out, lse (fp32 (B, H, Sq)), B, Sq, Sk, H, D, stream
    "gswm_flash_split_lse": [_VP] * 5 + [_I] * 5 + [_VP],
    # qkv, out, B, S, P (head pairs), stream
    "gswm_flash_packed": [_VP, _VP, _I, _I, _I, _VP],
    # qkv_t, out_t, B, S, H, D (head dim), stream
    "gswm_flash_transposed": [_VP, _VP, _I, _I, _I, _I, _VP],
    # x, weight, bias, out, B, C, HW, G, eps, act, stream
    "gswm_group_norm": [_VP] * 4 + [_I] * 4 + [_F, _I, _VP],
}


class Library:
    """The loaded kernels plus how they were built."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_seconds: float,
                 log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds  # 0.0 when a cached build was loaded
        self.log = log  # nvcc's output, -Xptxas -v register/smem report

    def call(self, name: str, *args) -> None:
        """Call a C entry point; raise if it reports a CUDA error."""
        err = getattr(self.lib, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err}")


_LIBRARY: Library | None = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float, str]:
    """Compile csrc/*.cu into the build directory unless already there.
    Returns (library path, seconds spent compiling, nvcc output)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    digest = _digest()
    out = BUILD_DIR / f"libgswm_kernels_{digest}.so"
    if out.exists():
        return out, 0.0, ""
    tag = f"{digest}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        jobs.append((obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = [(obj, proc.communicate()[0], proc.returncode) for obj, proc in jobs]
    log = "".join(text for _, text, _ in logs)
    objs = [obj for obj, _, _ in logs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        failed = [obj.name for obj, _, rc in logs if rc != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        log += res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out, time.perf_counter() - t0, log


def library() -> Library:
    """The kernel library, built on first call."""
    global _LIBRARY
    if _LIBRARY is None:
        path, seconds, log = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBRARY = Library(lib, path, seconds, log)
    return _LIBRARY


def launch(device, name: str, *args) -> None:
    """Call the C entry point ``name`` with ``args`` and, last, the raw
    handle of PyTorch's current stream on the CUDA ``device``; raise if it
    reports a CUDA error.  The wrappers whose host time counts go through
    here: the handle comes straight from the runtime (no Stream object), and
    the device is switched only when it is not the current one."""
    import torch

    lib = library()
    if device.index == torch._C._cuda_getDevice():
        lib.call(name, *args, torch._C._cuda_getCurrentRawStream(device.index))
    else:
        with torch.cuda.device(device):
            lib.call(name, *args, torch._C._cuda_getCurrentRawStream(device.index))


def refuse_grad(wrapper: str, *tensors) -> None:
    """Raise RuntimeError when a kernel wrapper is called where autograd
    would record it: grad mode on and any input that requires grad.  The
    kernels write into tensors they allocate, so their outputs would carry
    no path back to the inputs; neither package has a backward for them.
    Called on the CUDA branch only, before anything is launched, and never
    answered with a fall back to the plain version."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{wrapper}: called under a gradient, and neither gswm nor gswm_torch "
            "has a backward for its kernel; run the forward under torch.no_grad() or "
            "torch.inference_mode() (the VAE fit takes its mid attention as "
            "GSWM_VAE_ATTN=chunked, plain PyTorch with autograd)")


def stream_handle(device) -> int:
    """The current PyTorch CUDA stream of ``device`` as a raw handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
