"""The float32 forms of csrc/flash_f32.cu (pair-packed, transposed, with the
log-sum-exp) and of csrc/group_norm.cu, on the CPU: what each wrapper hands
its C entry on a CUDA tensor, which kernel the rules name, the sources'
shape and the bounds.

This machine has no card, so the wrappers' CUDA branches run on stand-ins:
``_OnCard`` tensors (metadata and an address, which is all a CUDA branch
reads) and a recorder in place of ``native.library()``.  Each float32 call
must reach its new C entry with the shapes the entry computes its bases and
pitches from, count on its float32 counters, and never touch the plain
version; the bf16 calls reach their entries exactly as before.  The kernels
themselves are held to their plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py phase 13); the plain versions to the
JAX package's in tests/test_torch_fp32.py, tests/test_torch_fp32_tiers.py,
tests/test_torch_groupnorm.py and tests/test_torch_ring_attention.py.
"""

import contextlib
import inspect
import re
from pathlib import Path

import pytest
import torch

from gswm_torch import native, roofline
from gswm_torch.ops import attention as attn
from gswm_torch.ops import groupnorm as gn

CSRC = Path(attn.__file__).resolve().parents[1] / "csrc"
STREAM = 0x5EED
SMS = 132  # an H100's SMs, what the float32 core's key split is sized by


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

    def contiguous(self):
        return self


_ADDRESSES = iter(range(0x100000, 1 << 40, 0x100000))


_MADE = {}  # address -> what the wrappers allocated on the card


def _made(shape, dtype):
    t = _OnCard(shape, dtype, next(_ADDRESSES))
    _MADE[t.address] = t
    return t


class _Recorder:
    """``native.library()``'s stand-in: every C call recorded, none run."""

    def __init__(self):
        self.calls = []

    def call(self, name, *args):
        self.calls.append((name, args))


@pytest.fixture
def card(monkeypatch):
    """The recorder in place of the kernel library, and what the CUDA
    branches ask of torch.cuda answered without a card; the plain versions
    replaced by a trap."""
    lib = _Recorder()
    monkeypatch.setattr(native, "library", lambda: lib)
    monkeypatch.setattr(native, "stream_handle", lambda device: STREAM)
    monkeypatch.setattr(attn, "_multiprocessors", lambda device: SMS)
    monkeypatch.setattr(native, "launch", lambda device, name, *args: lib.call(
        name, *args, STREAM))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch, "empty_like", lambda t: _made(t.shape, t.dtype))
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda shape, dtype=None, device=None: (
        _made(shape, dtype) if torch.device(device).type == "cuda"
        else real_empty(shape, dtype=dtype, device=device)))

    def trap(*args, **kwargs):
        raise AssertionError("a plain version ran on a CUDA tensor")

    for name in ("flash_attention_packed_reference", "flash_attention_transposed_reference",
                 "flash_attention_split_lse_reference", "flash_attention_split_reference"):
        monkeypatch.setattr(attn, name, trap)
    monkeypatch.setattr(gn, "fused_group_norm_reference", trap)
    return lib


def _counts(wrapper, names):
    return {name: (lambda v: dict(v) if isinstance(v, dict) else v)(getattr(wrapper, name))
            for name in names}


def _moved(before, after):
    """The counters that changed, and by how much (dicts: by key)."""
    out = {}
    for name, old in before.items():
        new = after[name]
        if isinstance(old, dict):
            diff = {k: n - old.get(k, 0) for k, n in new.items() if n != old.get(k, 0)}
            if diff:
                out[name] = diff
        elif new != old:
            out[name] = new - old
    return out


def _f32_steps(calls, q, k, v, out, lse, b, sq, sk, h, d, q_pitch, kv_pitch, out_pitch,
               transposed, vec):
    """The C calls of one float32 attention call (``ops.attention.f32_core``):
    the split pre-pass into a scratch of ``f32_scratch_numel`` floats, the
    core over ``f32_key_splits`` chunks and, where there are more than one,
    the combine of a workspace of ``f32_workspace_numel`` floats, each with
    the form's pointers and pitches; both buffers fp32 on the card."""
    splits = attn.f32_key_splits(b, sq, sk, h, d, SMS)
    assert [name for name, _ in calls] == ["gswm_flash_f32_prepass", "gswm_flash_f32_core"] + \
        (["gswm_flash_f32_combine"] if splits > 1 else [])
    scratch = calls[0][1][2]
    assert _MADE[scratch].shape == (attn.f32_scratch_numel(b, sk, h, d),)
    assert _MADE[scratch].dtype == torch.float32
    assert calls[0] == ("gswm_flash_f32_prepass", (k, v, scratch, b, sk, h, d, kv_pitch,
                                                   int(transposed), STREAM))
    ws = calls[1][1][4]
    if splits > 1:
        assert _MADE[ws].shape == (attn.f32_workspace_numel(splits, b, sq, h, d),)
        assert calls[2] == ("gswm_flash_f32_combine", (ws, out, lse, b, sq, h, d, out_pitch,
                                                       int(transposed), splits, STREAM))
    else:
        assert ws is None
    assert calls[1] == ("gswm_flash_f32_core", (q, scratch, out, lse, ws, b, sq, sk, h, d,
                                                q_pitch, out_pitch, int(transposed), int(vec),
                                                splits, STREAM))
    return splits


PACKED_COUNTERS = ("launches", "launches_by_d", "launches_f32", "launches_f32_by_d")
TRANSPOSED_COUNTERS = (*PACKED_COUNTERS, "launches_by_kernel")
SPLIT_COUNTERS = (*PACKED_COUNTERS, "lse_launches", "lse_launches_by_d",
                  "lse_launches_f32", "lse_launches_f32_by_d")


@pytest.mark.parametrize("dtype,entry", [(torch.float32, "gswm_flash_f32_core"),
                                         (torch.bfloat16, "gswm_flash_packed")], ids=str)
@pytest.mark.parametrize("b,s,pairs", [(2, 9216, 3), (1, 1000, 2), (4, 1, 1)])
def test_packed_reaches_its_entry(card, dtype, entry, b, s, pairs):
    """K6: (B, S, 3 P 128) qkv -> in bf16 its entry with (qkv, out, B, S,
    P), in float32 the three steps on the column bands with the array's
    pitches; an output of (B, S, P 128) in qkv's dtype; one launch at d =
    64 on the counter of that dtype."""
    qkv = _OnCard((b, s, 3 * pairs * 128), dtype, 0x1000)
    before = _counts(attn.flash_attention_packed, PACKED_COUNTERS)
    out = attn.flash_attention_packed(qkv)
    assert out.shape == (b, s, pairs * 128) and out.dtype == dtype
    if dtype == torch.float32:  # q, k, v: the column bands of rows of 3 P 128 floats
        width = pairs * 128
        _f32_steps(card.calls, 0x1000, 0x1000 + 4 * width, 0x1000 + 8 * width, out.address,
                   None, b, s, s, 2 * pairs, 64, 3 * width, 3 * width, width, False, True)
    else:
        assert card.calls == [(entry, (0x1000, out.address, b, s, pairs, STREAM))]
    f32 = "_f32" if dtype == torch.float32 else ""
    assert _moved(before, _counts(attn.flash_attention_packed, PACKED_COUNTERS)) == {
        f"launches{f32}": 1, f"launches{f32}_by_d": {64: 1}}


@pytest.mark.parametrize("b,s,h,d", [(2, 9216, 5, 64), (4, 4096, 8, 40), (4, 1024, 8, 80),
                                     (8, 324, 8, 160), (1, 1024, 1, 512), (1, 1001, 3, 64),
                                     (1, 1001, 2, 160), (2, 577, 1, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_transposed_reaches_its_entry(card, dtype, b, s, h, d):
    """K7: (3 H D, B, S) qkv_t -> in bf16 its entry with (qkv_t, out_t, B,
    S, H, D), in float32 the three steps on the row bands (q by 16-byte
    copies where S % 4 == 0), an output of (H D, B, S); counted by head dim on the
    counter of its dtype and by the kernel ``transposed_kernel`` names: in
    float32 the 4-byte form where S % 4 != 0, in bf16 the hand-loaded one
    where S % 8 != 0."""
    qkv_t = _OnCard((3 * h * d, b, s), dtype, 0x2000)
    before = _counts(attn.flash_attention_transposed, TRANSPOSED_COUNTERS)
    out = attn.flash_attention_transposed(qkv_t, h)
    assert out.shape == (h * d, b, s) and out.dtype == dtype
    f32 = dtype == torch.float32
    if f32:  # q, k, v: the row bands, B S floats between a head's columns
        band = h * d * b * s
        _f32_steps(card.calls, 0x2000, 0x2000 + 4 * band, 0x2000 + 8 * band, out.address,
                   None, b, s, s, h, d, b * s, b * s, b * s, True, s % 4 == 0)
    else:
        assert card.calls == [("gswm_flash_transposed", (0x2000, out.address, b, s, h, d,
                                                         STREAM))]
    kernel = attn.transposed_kernel(d, s, dtype)
    if f32:
        panels = -(-d // 64)
        tail = {40: 40, 80: 16, 160: 32}.get(d, 64)
        assert kernel == f"flash_f32_kernel<{panels}, {tail}, transposed>" + \
            ("/4-byte" if s % 4 else "")
    else:
        assert kernel == attn.transposed_kernel(d, s)
    tag = "_f32" if f32 else ""
    assert _moved(before, _counts(attn.flash_attention_transposed, TRANSPOSED_COUNTERS)) == {
        f"launches{tag}": 1, f"launches{tag}_by_d": {d: 1}, "launches_by_kernel": {kernel: 1}}


@pytest.mark.parametrize("b,sq,sk,h,d", [(2, 9216, 9216, 5, 64), (4, 1024, 4096, 8, 40),
                                         (4, 1024, 1024, 8, 80), (1, 4096, 16384, 1, 512),
                                         (2, 1001, 577, 3, 72)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_split_with_lse_reaches_its_entry(card, dtype, b, sq, sk, h, d):
    """K4 with its log-sum-exp: in bf16 the ``_lse`` entry with (q, k, v,
    out, lse, B, Sq, Sk, H, D), in float32 the three steps with the lse
    pointer (the core's, or the combine's where the keys split); lse fp32
    (B, H, Sq) in either dtype; counted on the lse counters of its dtype
    alone.  Without lse: the plain entry, or the steps with a null lse."""
    q = _OnCard((b, sq, h, d), dtype, 0x3000)
    k, v = _OnCard((b, sk, h, d), dtype, 0x4000), _OnCard((b, sk, h, d), dtype, 0x5000)
    before = _counts(attn.flash_attention_split, SPLIT_COUNTERS)
    out, lse = attn.flash_attention_split(q, k, v, return_lse=True)
    assert out.shape == (b, sq, h, d) and out.dtype == dtype
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    f32 = dtype == torch.float32
    if f32:
        _f32_steps(card.calls, 0x3000, 0x4000, 0x5000, out.address, lse.address, b, sq, sk,
                   h, d, h * d, h * d, h * d, False, True)
    else:
        assert card.calls == [("gswm_flash_split_lse", (0x3000, 0x4000, 0x5000, out.address,
                                                        lse.address, b, sq, sk, h, d, STREAM))]
    tag = "_f32" if f32 else ""
    assert _moved(before, _counts(attn.flash_attention_split, SPLIT_COUNTERS)) == {
        f"lse_launches{tag}": 1, f"lse_launches{tag}_by_d": {d: 1}}
    card.calls.clear()
    out = attn.flash_attention_split(q, k, v)
    if f32:
        _f32_steps(card.calls, 0x3000, 0x4000, 0x5000, out.address, None, b, sq, sk, h, d,
                   h * d, h * d, h * d, False, True)
    else:
        assert card.calls == [("gswm_flash_split", (0x3000, 0x4000, 0x5000, out.address, b,
                                                    sq, sk, h, d, STREAM))]


def test_split_with_lse_below_512_keys_takes_the_einsum_branch(card):
    """Below ``SPLIT_MIN_KEYS`` keys the wrapper keeps the reference's
    einsum branch on every device: no C call, no count (a CPU tensor here,
    since the branch computes)."""
    q = torch.randn((1, 300, 2, 64))
    before = _counts(attn.flash_attention_split, SPLIT_COUNTERS)
    out, lse = attn.flash_attention_split(q, q, q, return_lse=True)
    assert out.shape == q.shape and lse.shape == (1, 2, 300)
    assert card.calls == [] and _moved(before, _counts(attn.flash_attention_split,
                                                       SPLIT_COUNTERS)) == {}


@pytest.mark.parametrize("dtype,entry,counter", [
    (torch.float32, "gswm_group_norm_f32", "launches_f32"),
    (torch.bfloat16, "gswm_group_norm", "launches")], ids=str)
@pytest.mark.parametrize("shape,act", [((1, 128, 768, 768), "silu"), ((2, 320, 96, 96), None),
                                       ((2, 64, 5, 7), "silu")])
def test_group_norm_reaches_its_entry(card, dtype, entry, counter, shape, act):
    """K8: x of its dtype -> the entry of that dtype with (x, weight, bias,
    out, B, C, HW, G, eps, act), the output in x's dtype, fp32 parameters
    passed as they are; one launch on the counter of its dtype."""
    x = _OnCard(shape, dtype, 0x6000)
    w, b = _OnCard(shape[1:2], torch.float32, 0x7000), _OnCard(shape[1:2], torch.float32,
                                                               0x8000)
    before = (gn.fused_group_norm.launches, gn.fused_group_norm.launches_f32)
    out = gn.fused_group_norm(x, w, b, 32, 1e-6, act)
    assert out.dtype == dtype and out.shape == shape
    hw = shape[2] * shape[3]
    assert card.calls == [(entry, (0x6000, 0x7000, 0x8000, out.address, shape[0], shape[1], hw,
                                   32, 1e-6, 1 if act else 0, STREAM))]
    after = (gn.fused_group_norm.launches, gn.fused_group_norm.launches_f32)
    want = (1, 0) if counter == "launches" else (0, 1)
    assert tuple(a - b_ for a, b_ in zip(after, before)) == want


@pytest.mark.parametrize("call", [
    lambda: attn.flash_attention_packed(_OnCard((1, 64, 384), torch.float16, 0x1000)),
    lambda: attn.flash_attention_transposed(_OnCard((384, 1, 64), torch.float16, 0x1000), 2),
    lambda: attn.flash_attention_split(*(_OnCard((1, 600, 2, 64), torch.float16, 0x1000),) * 3,
                                       return_lse=True),
    lambda: gn.fused_group_norm(_OnCard((1, 64, 4, 4), torch.float16, 0x1000),
                                _OnCard((64,), torch.float32, 0x2000),
                                _OnCard((64,), torch.float32, 0x3000)),
    lambda: attn.flash_attention_packed(_OnCard((1, 64, 384), torch.float64, 0x1000)),
], ids=["K6", "K7", "K4 + lse", "K8", "K6 float64"])
def test_float16_and_others_still_raise(card, call):
    """No kernel takes float16 (the JAX pipeline never runs it) or float64:
    a TypeError naming the dtype, and nothing called."""
    with pytest.raises(TypeError, match=r"float16|float64"):
        call()
    assert card.calls == []


D_ALL = tuple(range(8, 513, 8))


@pytest.mark.parametrize("d", D_ALL)
def test_dtype_kernel_names_flash_f32_at_every_head_dim(d):
    """float32 at every d % 8 == 0 from 8 to 512: ``flash_f32_kernel<P, N>``
    in the natural layout (with the log-sum-exp: the same kernel, its core
    entry), ``flash_f32_kernel<P, N, transposed>`` in the transposed one, P
    = ceil(d / 64), N p v's width of the last panel (exact at 40, 80, 160;
    64 elsewhere); the pair-packed layout at d = 64 alone; float16 a
    TypeError in every layout."""
    panels = -(-d // 64)
    tail = {40: 40, 80: 16, 160: 32}.get(d, 64)
    assert attn.dtype_kernel(torch.float32, d) == f"flash_f32_kernel<{panels}, {tail}>"
    assert attn.dtype_kernel(torch.float32, d, "transposed") == \
        f"flash_f32_kernel<{panels}, {tail}, transposed>"
    assert attn._flash_entry(torch.float32, d, lse=True) == "gswm_flash_f32_core"
    assert attn._flash_entry(torch.bfloat16, d, lse=True) == "gswm_flash_split_lse"
    if d == 64:
        assert attn.dtype_kernel(torch.float32, d, attn.PACKED) == "flash_f32_kernel<1, 64>"
        assert attn.dtype_kernel(torch.bfloat16, d, attn.PACKED) == "flash_hopper_kernel"
    else:
        with pytest.raises(ValueError):
            attn.dtype_kernel(torch.float32, d, attn.PACKED)
    for layout in (*attn.LAYOUTS, attn.PACKED):
        with pytest.raises(TypeError, match="float16"):
            attn.dtype_kernel(torch.float16, 64 if layout == attn.PACKED else d, layout)


def test_float32_bounds_of_the_new_forms():
    """By hand: fp32 K6 and K7 cost what fp32 attention on their real heads
    costs, at 3xTF32; K4 + lse adds its fp32 (B, H, Sq) bytes; fp32 K8 one
    read and one write of 4 bytes an element against 3.35 TB/s."""
    # K6 at (2, 9216, 5 heads, 3 pairs): the 5 real heads of 64
    cost = roofline.attention_cost(2, 9216, 9216, 5, 64, elem=roofline.F32)
    assert cost == (4 * 2 * 5 * 9216**2 * 64, 4 * 2 * 5 * 64 * 4 * 9216, 2 * 5 * 9216**2)
    ms, by = roofline.attention_bound_ms(cost, roofline.PEAK_F32_PRODUCTS)
    assert by == "operations" and ms == pytest.approx(1.3191, rel=1e-3)
    # K4 + lse at (1, 16384, 1, 512)
    lse = roofline.attention_cost(1, 16384, 16384, 1, 512, lse=True, elem=roofline.F32)
    plain = roofline.attention_cost(1, 16384, 16384, 1, 512, elem=roofline.F32)
    assert lse[1] - plain[1] == 4 * 16384 and lse[0] == plain[0]
    # K8 in fp32 at the 768x768 VAE's largest GroupNorm: 2 x 4 x 75.5 M bytes
    ops, nbytes = roofline.group_norm_cost((1, 128, 768, 768), roofline.F32)
    assert nbytes == 2 * 4 * 128 * 768 * 768 == 2 * roofline.group_norm_cost(
        (1, 128, 768, 768))[1]
    ms, by = roofline.bound_ms(ops, nbytes, roofline.PEAK_FP32)
    assert by == "bytes" and ms == pytest.approx(0.1803, rel=2e-3)


def _code(name: str) -> str:
    """A CUDA source without its // comments."""
    return "\n".join(line.split("//")[0] for line in (CSRC / name).read_text().splitlines())


def test_flash_f32_is_one_kernel_body_with_the_layout_a_template_parameter():
    """csrc/flash_f32.cu: one attention kernel body, templated on the panel
    count, p v's last width and the layout, every form one of its
    instances; the layout a parameter of q's loads and the output's stores
    alone (k and v come from the pre-pass's one layout, by TMA); products on 3xTF32
    wgmma, no FFMA loop; the log-sum-exp a runtime pointer, not a template
    flag; the natural entry's signature as before; the 4-byte copies a
    runtime argument; beside it only the pre-pass and the combine, and no
    try, no switch to another kernel."""
    code = _code("flash_f32.cu")
    assert code.count("__global__") == 3
    assert "enum class Layout { natural, transposed };" in code
    assert "template <int P, int N, Layout L>\n__global__" in code
    assert "template <Layout L>\n__global__ void __launch_bounds__(STEP_THREADS)\nsplit_kv_kernel(" in code
    assert "template <Layout L>\n__global__ void __launch_bounds__(STEP_THREADS)\ncombine_kernel(" in code
    assert code.count("extern __shared__") == 1 and code.count("__shared__") == 2
    # q's loads and the output's stores read L; k and v do not
    assert "q_index<P, L>(" in code and "stage_q<P, L>(" in code
    assert "produce_panel<P>(" in code and "produce_panel<P, L>" not in code
    assert "__grid_constant__ CUtensorMap map_k" in code and "tma_load_2d(" in code
    assert "wgmma_3xtf32_rs<NK>(" in code and "wgmma_3xtf32_rs<N>(" in code
    # fmaf only on a logit scaled into the exponent, no product on FFMA
    assert set(re.findall(r"fmaf\((\w+)\[", code)) == {"s"} and "try" not in code
    assert ".f32.tf32.tf32" in _code("hopper.cuh") and "cvt.rna.tf32.f32" in _code("hopper.cuh")
    assert re.search(r"float\* lse;", code) and "a.lse != nullptr" in code
    assert "LSE" not in code.replace("LN2", "")
    assert 'extern "C" int gswm_flash_f32(const void* q, const void* k, const void* v, ' \
           'void* out, int B,\n                              int Sq, int Sk, int H, int D, ' \
           'void* stream)' in code
    for entry in ("gswm_flash_f32", "gswm_flash_f32_lse", "gswm_flash_f32_packed",
                  "gswm_flash_f32_transposed", "gswm_flash_f32_transposed_4byte",
                  "gswm_flash_f32_prepass", "gswm_flash_f32_core", "gswm_flash_f32_combine"):
        assert f'extern "C" int {entry}(' in code, entry
        assert entry in native._SIGNATURES, entry
    assert code.count("run<Layout::natural>(") == 1 and code.count("run<Layout::transposed>(") == 1
    # the packed entry: q, k, v the column bands of one row of 3 P 128
    # floats, 2 P heads of 64; the transposed one: the row bands of (3 H D,
    # B, S), B * S floats between a head's columns
    assert "unsplit(q, q + width, q + 2 * width, static_cast<float*>(out), nullptr, B, S, S,\n" \
           "                 2 * pairs, 64, 3 * width, 3 * width, width, false, true, stream)" in code
    assert "const size_t band = (size_t)H * D * bs;" in code
    assert "bs, bs, bs, true, S % 4 == 0, stream" in code and "bs, bs, bs, true, false, stream" in code
    # the instances: exact widths where users run them, 64-column panels elsewhere
    for inst in ("launch<1, 40, L>", "launch<2, 16, L>", "launch<3, 32, L>",
                 *(f"launch<{p}, 64, L>" for p in range(1, 9))):
        assert inst in code, inst
    assert code.count("launch<") == 11


def test_qkv_proj_f32_runs_its_products_on_3xtf32_wgmma():
    """csrc/qkv_proj_f32.cu: one kernel, both operands K-major in 128-byte
    swizzled slices, w split in shared memory and x's fragments in
    registers, three m64n128k8 tf32 products a step (3xTF32), no FFMA; the
    entry's signature and limits as before."""
    code = _code("qkv_proj_f32.cu")
    assert code.count("__global__") == 1
    assert "wgmma_3xtf32_rs<TILE>(" in code and "constexpr int TILE = 128;" in code
    assert "split_tf32(wbig[i], big, small);" in code and "split_fragment(" in code
    assert "fmaf(" not in code and "try" not in code
    assert "wgmma_tf32_m64n128k8_rs" in _code("hopper.cuh")
    assert 'extern "C" int gswm_qkv_proj_f32(const void* x, const void* wq, const void* wk,\n' \
           '                                 const void* wv, void* q, void* k, void* v, int M, ' \
           'int C,\n                                 int N, void* stream)' in code
    assert "if (M < 1 || C < 64 || C % 64 || N < 64 || N % 64)" in code
    assert native._SIGNATURES["gswm_qkv_proj_f32"] == native._SIGNATURES["gswm_qkv_proj"]


def test_group_norm_takes_the_element_type_as_a_template_parameter():
    """csrc/group_norm.cu: the cluster kernel, the persistent grid (NCHW)
    and the slab kernel (channels-last x, clusters or a grid, a template
    parameter), each templated on its element type, a bf16 and a float32
    entry on one sizing (in bytes), the 16-byte vectors of 8 bf16 or 4
    floats; no other kernel outside the measurement build."""
    code = _code("group_norm.cu")
    program = re.sub(r"#ifdef GN_PHASE_STAMPS.*?#(else|endif)", "", code, flags=re.S)
    assert "template <typename E, bool VEC, int THREADS, bool SILU>\n__global__" in code
    assert "template <typename E, int THREADS>\n__global__" in code
    assert "template <typename E, bool VEC, bool CLUSTER>\n__global__" in code
    assert program.count("__global__") == 3
    assert "return group_norm<bf16>(" in code and "return group_norm<float>(" in code
    assert "static constexpr int VEC = 8;" in code and "static constexpr int VEC = 4;" in code
    assert native._SIGNATURES["gswm_group_norm_f32"] == native._SIGNATURES["gswm_group_norm"]


@pytest.mark.parametrize("wrapper", [attn.flash_attention_packed, attn.flash_attention_transposed,
                                     attn.flash_attention_split, gn.fused_group_norm],
                         ids=lambda w: w.__name__)
def test_no_wrapper_catches_a_launch_failure(wrapper):
    """A failed build or launch raises through the wrapper: no try, no
    except, no path back to the plain version after the CUDA branch
    starts."""
    src = inspect.getsource(wrapper)
    assert not re.search(r"^\s*(try|except)\b", src, re.MULTILINE)
    cuda_branch = src[src.index("refuse_grad"):]
    assert "_reference(" not in cuda_branch
