"""K7 above d = 160 on flash_split.cu's kernel, on the CPU.

Where S % 8 != 0 no tensor map reaches the transposed layout's rows, so a
pre-pass (csrc/flash_transposed.cu align_tokens_kernel) copies the (3 H d,
B, S) input into scratch whose token pitch is S rounded up to 8, and
flash_split.cu's kernel, the layout a template parameter, reads that by
tensor maps at the true S.  Here: the pre-pass's plain model, and the plain
K7 built on it at d = 192, 256 and 512, S of 13, 77 and 1001, one and two
heads, against the JAX package's Pallas ``flash_attention_transposed``
(interpret mode) on float32 inputs whose logits stay below 60 (the TPU
kernel drops the running max and clamps logits at 60; the two agree within
float32 rounding below that): within 2e-5, the fp32 tolerance of
tests/test_torch_attention.py.  Then the wrapper's C call at S % 8 != 0 on
a recorder in place of the library (one entry, which runs the pre-pass
and the core), the
names ``transposed_kernel`` gives the forms, and the sources' shape.  The
kernels are held bit for bit to the natural layout's kernel on the card
(tests/test_torch_gpu.py, chip_smoke.py phase 2).
"""

import contextlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gswm.ops.attention import flash_attention_transposed as j_flash_transposed
from gswm_torch import native
from gswm_torch.ops import attention as attn

CSRC = Path(attn.__file__).resolve().parents[1] / "csrc"
STREAM = 0x5EED
TOL = 2e-5


def _code(name: str) -> str:
    """A CUDA source without its // comments."""
    return "\n".join(line.split("//")[0] for line in (CSRC / name).read_text().splitlines())


@pytest.mark.parametrize("s", [1, 13, 77, 324, 1001, 1024])
def test_align_tokens_reference_pads_rows_to_a_multiple_of_8(s):
    """The pre-pass's plain model: each row of S tokens into a row of
    ``aligned_pitch(S)`` (S rounded up to 8), the same tokens first and
    zeros after; read back at the true S it is the input."""
    pitch = attn.aligned_pitch(s)
    assert pitch % 8 == 0 and s <= pitch < s + 8
    x = torch.from_numpy(np.random.default_rng(s).standard_normal((6, 2, s)).astype(
        np.float32)).bfloat16()
    padded = attn.align_tokens_reference(x, pitch)
    assert padded.shape == (6, 2, pitch) and padded.dtype == torch.bfloat16
    assert torch.equal(padded[..., :s], x)
    assert not padded[..., s:].any()


@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("s", [13, 77, 1001])
@pytest.mark.parametrize("d", [192, 256, 512])
def test_plain_k7_over_the_prepass_matches_jax(d, s, h):
    """The plain K7 built on the pre-pass (``flash_attention_transposed_
    aligned_reference``) against JAX's Pallas kernel in interpret mode,
    float32, logits below 60: within 2e-5; and equal to the plain K7 on the
    unpadded input, since no token past S reaches the products."""
    b = 1
    rng = np.random.default_rng(d + s + h)
    qkv_t = (rng.standard_normal((3 * h * d, b, s)) * 0.3).astype(np.float32)
    q = qkv_t[:h * d].reshape(h, d, b, s)
    k = qkv_t[h * d:2 * h * d].reshape(h, d, b, s)
    logits = np.einsum("hdbq,hdbk->hbqk", q, k) / np.sqrt(d)
    assert np.abs(logits).max() < 60
    got = attn.flash_attention_transposed_aligned_reference(torch.from_numpy(qkv_t), h)
    want = np.asarray(j_flash_transposed(jnp.asarray(qkv_t), h, d, interpret=True))
    assert got.shape == want.shape == (h * d, b, s)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    assert torch.equal(got, attn.flash_attention_transposed_reference(
        torch.from_numpy(qkv_t), h))


@pytest.mark.parametrize("d", [192, 256, 320, 384, 448, 512, 168, 504])
def test_transposed_kernel_names_the_split_design_and_its_aligned_form(d):
    """Above d = 160 K7's design is flash_split.cu's kernel in both
    layouts; at S % 8 != 0 ``transposed_kernel`` appends ``ALIGNED_FORM``,
    never the hand-loaded form, and at S % 8 == 0 the name alone."""
    assert attn.head_dim_kernel(d, "transposed") == attn.head_dim_kernel(d) == \
        ("flash_split_kernel", -(-d // 64), 0)
    for s in (1, 13, 324, 1001):
        assert attn.transposed_kernel(d, s) == "flash_split_kernel" + attn.ALIGNED_FORM
    for s in (8, 1024, 4096):
        assert attn.transposed_kernel(d, s) == "flash_split_kernel"
    assert attn.transposed_kernel(160, 1001) == "flash_mid_kernel" + attn.ROWS_FORM


# ---- the wrapper's C calls, on a recorder -----------------------------------

class _OnCard:
    """Stands in for a contiguous, 16-byte aligned tensor on a card."""

    device = torch.device("cuda", 0)
    requires_grad = False

    def __init__(self, shape, dtype, address):
        self.shape, self.dtype, self.address = torch.Size(shape), dtype, address

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return self.address

    def new_empty(self, shape):
        return _made(shape, self.dtype)


_ADDRESSES = iter(range(0x100000, 1 << 40, 0x100000))
_MADE = {}


def _made(shape, dtype):
    t = _OnCard(shape, dtype, next(_ADDRESSES))
    _MADE[t.address] = t
    return t


class _Recorder:
    def __init__(self):
        self.calls = []

    def call(self, name, *args):
        self.calls.append((name, args))


@pytest.fixture
def card(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(native, "library", lambda: lib)
    monkeypatch.setattr(native, "stream_handle", lambda device: STREAM)
    monkeypatch.setattr(native, "launch", lambda device, name, *args: lib.call(
        name, *args, STREAM))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())

    def trap(*args, **kwargs):
        raise AssertionError("a plain version ran on a CUDA tensor")

    monkeypatch.setattr(attn, "flash_attention_transposed_reference", trap)
    return lib


COUNTERS = ("launches", "align_launches")


@pytest.mark.parametrize("b,s,h,d", [(1, 1001, 1, 512), (1, 1001, 2, 192), (2, 324, 2, 256),
                                     (3, 13, 1, 168)])
def test_unaligned_split_makes_the_one_entry_call(card, b, s, h, d):
    """bf16 K7 at d > 160 and S % 8 != 0: the wrapper makes one C call,
    ``gswm_flash_transposed`` (whose pre-pass and core run from it, the
    scratch from the stream's pool), and allocates nothing but the (H d, B,
    S) result.  One launch of K7 counted, one of the pre-pass, by kernel
    the aligned form."""
    qkv_t = _OnCard((3 * h * d, b, s), torch.bfloat16, 0x2000)
    before = {n: getattr(attn.flash_attention_transposed, n) for n in COUNTERS}
    kernels = dict(attn.flash_attention_transposed.launches_by_kernel)
    made = len(_MADE)
    out = attn.flash_attention_transposed(qkv_t, h)
    assert out.shape == (h * d, b, s) and out.dtype == torch.bfloat16
    assert len(_MADE) == made + 1
    assert card.calls == [("gswm_flash_transposed", (0x2000, out.address, b, s, h, d,
                                                     STREAM))]
    moved = {n: getattr(attn.flash_attention_transposed, n) - before[n] for n in COUNTERS}
    assert moved == {"launches": 1, "align_launches": 1}
    kernel = "flash_split_kernel" + attn.ALIGNED_FORM
    assert attn.flash_attention_transposed.launches_by_kernel[kernel] == \
        kernels.get(kernel, 0) + 1


@pytest.mark.parametrize("b,s,h,d", [(1, 1024, 1, 512), (1, 1001, 2, 160), (2, 324, 8, 160),
                                     (1, 1001, 3, 64)])
def test_other_shapes_keep_the_one_entry(card, b, s, h, d):
    """At S % 8 == 0, and at d <= 160 at any S, the wrapper makes the one
    C call it made: ``gswm_flash_transposed``, no pre-pass."""
    qkv_t = _OnCard((3 * h * d, b, s), torch.bfloat16, 0x4000)
    before = attn.flash_attention_transposed.align_launches
    out = attn.flash_attention_transposed(qkv_t, h)
    assert card.calls == [("gswm_flash_transposed", (0x4000, out.address, b, s, h, d,
                                                     STREAM))]
    assert attn.flash_attention_transposed.align_launches == before


# ---- the sources --------------------------------------------------------------

def test_split_kernel_takes_the_layout_and_the_old_kernel_is_gone():
    """flash_split.cu's one kernel body takes the tiles' layout and the
    output's as template parameters (natural for K4, transposed for K7 with
    MN-major q and k and K-major v through the register-A wrapper's
    transpose bit, the output transposed into the q tile and out by TMA or
    by hand); the natural instances keep their launch; flash_transposed.cu
    holds no split kernel of its own any more, only the pre-pass, which its
    C entry runs before the core on scratch from the stream's pool (the
    pool's policy left alone) and which the native table binds alone for
    the smoke's check."""
    split = _code("flash_split.cu")
    assert "template <int D, Layout L, Layout LO, bool LSE>\n__global__" in split
    assert "flash_split_kernel<D, Layout::natural, Layout::natural, LSE>" in split
    assert "flash_split_kernel<D, Layout::transposed, LO, false>" in split
    assert "if constexpr (T)" in split
    transposed = _code("flash_transposed.cu")
    assert "flash_transposed_split_kernel" not in transposed
    assert "__global__ void __launch_bounds__(MOVE_THREADS)\nalign_tokens_kernel(" in transposed
    assert 'extern "C" int gswm_flash_transposed_align(' in transposed
    assert "gswm_flash_transposed_align" in native._SIGNATURES
    for gone in ("unalign_tokens_kernel", "gswm_flash_transposed_core",
                 "gswm_flash_transposed_unalign"):
        assert gone not in transposed and gone not in native._SIGNATURES
    assert "cudaMemPoolSetAttribute" not in "".join(
        _code(p.name) for p in sorted(CSRC.glob("*.cu")))
    split = transposed.split("cudaError_t launch_split_aligned(")[1].split("\n}\n")[0]
    assert split.index("cudaMallocAsync(") < split.index("align_tokens(") < split.index(
        "gswm_launch_flash_split_transposed(padded, pitch, out, true,") < split.index(
        "cudaFreeAsync(")
    entry = transposed.split('extern "C" int gswm_flash_transposed(')[1].split("\n}\n")[0]
    assert "S % 8 != 0" in entry
    assert "flash_transposed_split_kernel" not in "".join(
        (CSRC / name).read_text() for name in ("flash_split.cu", "flash_core.cuh",
                                               "hopper.cuh"))
