"""The port's native host library (``gswm_native.cpp``): ChaCha20 keystream,
quantization, decode and match count for the traceability search's host
loop (``eval.trace.find_source``).  The counterpart of ``gswm.native``.

``g++ -O3 -shared -fPIC`` compiles the source at first use into
``build/gswm_torch_host/`` at the root of the checkout, under a file name
that hashes the source, the flags and the machine's architecture
(``platform.machine()``); there is no ``-march=native``, so a library built on
one host of an architecture runs on every other.  ``ctypes`` loads it.  A
build that fails raises RuntimeError with the compiler's output: there is no
fallback (the numpy functions of ``eval.trace`` are the plain versions the
tests compare it with).  Not to be confused with ``gswm_torch.native``,
which builds the CUDA kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "gswm_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gswm_torch_host"
FLAGS = ["-O3", "-shared", "-fPIC"]

_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_F32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_SIGNATURES = {
    "chacha20_keystream": ([ctypes.c_char_p, ctypes.c_char_p, _U8, ctypes.c_uint64], None),
    "gs_quantize_bits": ([_F32, ctypes.c_uint64, ctypes.c_int, _U8], None),
    "gs_decode": ([_U8, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint32,
                   _U8], None),
    "gs_match_accuracy": ([_U8, _U8, ctypes.c_uint32], ctypes.c_double),
}


class Library:
    """The loaded library plus how it was built."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_seconds: float):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds  # 0.0 when a built library was loaded


_LIBRARY: Library | None = None


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> tuple[Path, float]:
    """Compile ``source`` into ``build_dir`` unless already there.  Returns
    (library path, seconds spent compiling); raises RuntimeError if there is
    no g++ or it fails."""
    source, build_dir = Path(source), Path(build_dir)
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(FLAGS).encode())
    h.update(platform.machine().encode())
    out = build_dir / f"libgswm_host_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out, 0.0
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native host library cannot be built")
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        res = subprocess.run([gxx, *FLAGS, str(source), "-o", str(tmp)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {source} ({res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        tmp.unlink(missing_ok=True)
    return out, time.perf_counter() - t0


def library() -> Library:
    """The host library, built on first call."""
    global _LIBRARY
    if _LIBRARY is None:
        path, seconds = build()
        lib = ctypes.CDLL(str(path))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _LIBRARY = Library(lib, path, seconds)
    return _LIBRARY


def _key_nonce(key: bytes, nonce16: bytes) -> tuple[bytes, bytes]:
    if len(key) != 32 or len(nonce16) != 16:
        raise ValueError(f"a 32-byte key and a 16-byte nonce, got {len(key)} and "
                         f"{len(nonce16)} bytes")
    return bytes(key), bytes(nonce16)


def chacha20_keystream(key: bytes, nonce16: bytes, n_bytes: int) -> bytes:
    """The first ``n_bytes`` of the ChaCha20 keystream, the nonce's first 8
    bytes the initial block counter (little-endian), as
    ``core.chacha.keystream_bytes_host``."""
    key, nonce16 = _key_nonce(key, nonce16)
    out = np.empty(n_bytes, dtype=np.uint8)
    library().lib.chacha20_keystream(key, nonce16, out, n_bytes)
    return out.tobytes()


def quantize_bits(latents: np.ndarray, l: int = 1) -> np.ndarray:
    """(...,) float latents -> (n * l,) uint8 bits, stream order: floor of the
    normal CDF (0.5 erfc(-z / sqrt 2) in double) times 2^l, clipped."""
    if not 1 <= l <= 30:
        raise ValueError(f"quantize_bits: l = {l}, the library takes 1 to 30 bits")
    flat = np.ascontiguousarray(latents, dtype=np.float32).ravel()
    out = np.empty(flat.size * l, dtype=np.uint8)
    library().lib.gs_quantize_bits(flat, flat.size, l, out)
    return out


def decode(quant_bits: np.ndarray, key: bytes, nonce16: bytes,
           message_bits: int) -> np.ndarray:
    """Quantized bit stream -> voted message bits: XOR with the keystream,
    strict majority over the complete segments (a tie gives 0)."""
    key, nonce16 = _key_nonce(key, nonce16)
    if message_bits < 1:
        raise ValueError(f"decode: message_bits = {message_bits}")
    qb = np.ascontiguousarray(quant_bits, dtype=np.uint8)
    out = np.empty(message_bits, dtype=np.uint8)
    library().lib.gs_decode(qb, qb.size, key, nonce16, message_bits, out)
    return out


def match_accuracy(voted: np.ndarray, expected: np.ndarray) -> float:
    """The share of positions where ``voted`` equals ``expected``."""
    v = np.ascontiguousarray(voted, dtype=np.uint8)
    e = np.ascontiguousarray(expected, dtype=np.uint8)
    if v.size != e.size:
        raise ValueError(f"{v.size} voted bits against {e.size} expected")
    return library().lib.gs_match_accuracy(v, e, v.size)
