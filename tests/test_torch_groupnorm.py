"""PyTorch port vs the JAX package: the fused GroupNorm op (K8).

The port's ``fused_group_norm`` takes NCHW and channels-minor x (C the
fastest-moving dimension, ``torch.channels_last``), the JAX op NHWC; inputs
come from a numpy seed and are either transposed at the boundary (NCHW) or
handed over as they are, the port seeing the same NHWC memory through
``permute(0, 3, 1, 2)`` (channels-minor).  On the CPU the port runs its
plain version, which must match the Pallas kernel in interpret mode in both
its modes (resident, twopass), with and without the fused SiLU, at both
epsilons the models use: fp32, atol 2e-5 (the bound of
tests/test_groupnorm_kernel.py).  The CUDA kernel is held against the plain
version on the card (tests/test_torch_gpu.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gswm.ops.groupnorm import fused_group_norm as j_fused_group_norm
from gswm_torch.models.layers import GroupNorm32
from gswm_torch.ops import groupnorm as gn

torch.set_num_threads(2)


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            + shift).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("mode", ["resident", "twopass"])
def test_reference_matches_jax_kernel(mode, act, eps):
    x = _rand((2, 4, 8, 64), 0, 2.0, 0.5)  # NHWC
    scale = _rand((64,), 1, 0.2, 1.0)
    bias = _rand((64,), 2, 0.2)
    want = np.asarray(j_fused_group_norm(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), groups=32, eps=eps,
        act=act, force_mode=mode, interpret=True)).transpose(0, 3, 1, 2)
    before = gn.fused_group_norm.launches
    got = gn.fused_group_norm(_nchw(x), torch.from_numpy(scale), torch.from_numpy(bias),
                              32, eps, act)
    assert gn.fused_group_norm.launches == before  # CPU: plain version
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("mode", ["resident", "twopass"])
@pytest.mark.parametrize("act", [None, "silu"])
def test_reference_matches_jax_kernel_in_fp32_at_unet_widths(mode, act):
    """K8's plain version in fp32 (the function csrc/group_norm.cu computes
    on float32 x) against the Pallas op in fp32 in both its modes, at a
    UNet level's width (320 channels, 32 groups, 12 x 12): an fp32 output
    in both, within 1e-5 of max |want| (fp32 sums in other orders)."""
    x = _rand((2, 12, 12, 320), 10, 1.5, 0.3)  # NHWC
    scale = _rand((320,), 11, 0.2, 1.0)
    bias = _rand((320,), 12, 0.2)
    want = np.asarray(j_fused_group_norm(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), groups=32, eps=1e-5,
        act=act, force_mode=mode, interpret=True))
    assert want.dtype == np.float32
    got = gn.fused_group_norm(_nchw(x), torch.from_numpy(scale), torch.from_numpy(bias),
                              32, 1e-5, act)
    assert got.dtype == torch.float32
    want = want.transpose(0, 3, 1, 2)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("mode", ["resident", "twopass"])
def test_channels_last_matches_jax_kernel_on_the_same_nhwc_memory(mode, act, eps):
    """The JAX op's own layout: one NHWC array, passed unchanged to the
    Pallas op and to the port as ``torch.from_numpy(x).permute(0, 3, 1, 2)``
    (channels-last, no copy); fp32, atol 2e-5; the output channels-last."""
    x = _rand((2, 4, 8, 64), 20, 2.0, 0.5)  # NHWC
    scale = _rand((64,), 21, 0.2, 1.0)
    bias = _rand((64,), 22, 0.2)
    want = np.asarray(j_fused_group_norm(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), groups=32, eps=eps,
        act=act, force_mode=mode, interpret=True))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    assert xt.is_contiguous(memory_format=torch.channels_last) and gn.layout_of(xt) == gn.NHWC
    got = gn.fused_group_norm(xt, torch.from_numpy(scale), torch.from_numpy(bias), 32, eps, act)
    assert got.is_contiguous(memory_format=torch.channels_last) and got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=2e-5)


@pytest.mark.parametrize("mode", ["resident", "twopass"])
@pytest.mark.parametrize("act", [None, "silu"])
def test_channels_last_matches_jax_kernel_in_fp32_at_unet_widths(mode, act):
    """The same at a UNet level's width (320 channels, 32 groups, 12 x 12):
    within 1e-5 of max |want|, the output channels-last."""
    x = _rand((2, 12, 12, 320), 23, 1.5, 0.3)  # NHWC
    scale = _rand((320,), 24, 0.2, 1.0)
    bias = _rand((320,), 25, 0.2)
    want = np.asarray(j_fused_group_norm(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), groups=32, eps=1e-5,
        act=act, force_mode=mode, interpret=True))
    got = gn.fused_group_norm(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(scale),
                              torch.from_numpy(bias), 32, 1e-5, act)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert np.abs(got.permute(0, 2, 3, 1).numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_layout_rule_names_the_entry_of_each_layout_and_dtype():
    """``layout_of`` tells contiguous x (NCHW) from channels-minor x (4-D
    channels-last, and 3-D (B, C, L) with C minor) and refuses other
    strides with a ValueError naming both; ``entry`` names one C entry a
    (layout, dtype) pair and refuses float16 with a TypeError."""
    x = torch.zeros((2, 64, 5, 7))
    assert gn.layout_of(x) == gn.NCHW
    assert gn.layout_of(x.contiguous(memory_format=torch.channels_last)) == gn.NHWC
    assert gn.layout_of(torch.zeros((2, 7, 64)).permute(0, 2, 1)) == gn.NHWC
    # one pixel, or one channel: both layouts hold the same memory, NCHW named
    assert gn.layout_of(torch.zeros((2, 64, 1, 1)).contiguous(
        memory_format=torch.channels_last)) == gn.NCHW
    for bad in (x[..., :3], x.transpose(2, 3), x[:, ::2], x.permute(0, 2, 1, 3)):
        with pytest.raises(ValueError, match="contiguous .NCHW.*channels-minor"):
            gn.layout_of(bad)
    assert {(layout, dtype): gn.entry(layout, dtype)
            for layout in (gn.NCHW, gn.NHWC) for dtype in (torch.bfloat16, torch.float32)} == {
        (gn.NCHW, torch.bfloat16): "gswm_group_norm",
        (gn.NCHW, torch.float32): "gswm_group_norm_f32",
        (gn.NHWC, torch.bfloat16): "gswm_group_norm_nhwc",
        (gn.NHWC, torch.float32): "gswm_group_norm_nhwc_f32"}
    with pytest.raises(TypeError, match="float16"):
        gn.entry(gn.NHWC, torch.float16)
    with pytest.raises(ValueError):
        gn.entry("nchwc", torch.bfloat16)
    from gswm_torch import native

    for name, _ in gn.ENTRIES.values():
        assert native._SIGNATURES[name] == native._SIGNATURES["gswm_group_norm"]


@pytest.mark.parametrize("shape,groups", [((2, 64, 5, 7), 32), ((1, 96, 3, 3), 8)])
def test_reference_matches_the_model_group_norm(shape, groups):
    """The op's plain version is the model's GroupNorm32 (F.group_norm in
    fp32) at ragged spatial sizes; fp32, atol 2e-5 (E[x^2] - E[x]^2 against
    F.group_norm's own variance)."""
    x = torch.from_numpy(_rand(shape, 3, 1.5, 0.2))
    mod = GroupNorm32(groups, shape[1], eps=1e-6)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(_rand((shape[1],), 4, 0.2, 1.0)))
        mod.bias.copy_(torch.from_numpy(_rand((shape[1],), 5, 0.2)))
        want = mod(x)
    got = gn.fused_group_norm(x, mod.weight, mod.bias, groups, 1e-6)
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), atol=2e-5)


def test_reference_keeps_bf16_and_computes_in_fp32():
    x = torch.from_numpy(_rand((2, 64, 4, 8), 6)).bfloat16()
    w, b = torch.ones(64), torch.zeros(64)
    got = gn.fused_group_norm(x, w, b, 32, 1e-6, "silu")
    assert got.dtype == torch.bfloat16
    want = gn.fused_group_norm_reference(x.float(), w, b, 32, 1e-6, "silu")
    # one bf16 rounding of outputs below 4: 2^-7
    torch.testing.assert_close(got.float(), want, rtol=0, atol=2**-7)


def test_rejects_what_it_does_not_take():
    x = torch.zeros((1, 64, 2, 2))
    w = torch.ones(64)
    with pytest.raises(ValueError):
        gn.fused_group_norm(x, w, w, 32, 1e-5, "gelu")
    with pytest.raises(ValueError):
        gn.fused_group_norm(x[:, :48], w[:48], w[:48], 32)  # 48 channels, 32 groups
    with pytest.raises(ValueError):
        gn.fused_group_norm(torch.empty((1, 64, 2, 2), device="meta"), w, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_reference_takes_parameters_of_any_float_dtype(dtype):
    """The plain version computes in fp32 whatever the parameters' dtype: the
    models keep their norms' scales and biases fp32, a caller may not."""
    x = torch.from_numpy(_rand((2, 64, 4, 8), 7, 1.5, 0.3))
    w = torch.from_numpy(_rand((64,), 8, 0.2, 1.0)).to(dtype)
    b = torch.from_numpy(_rand((64,), 9, 0.2)).to(dtype)
    got = gn.fused_group_norm(x, w, b, 32, 1e-5, "silu")
    want = gn.fused_group_norm_reference(x, w.float(), b.float(), 32, 1e-5, "silu")
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_kernel_source_is_one_launch_that_keeps_the_group_on_chip():
    """csrc/group_norm.cu: one launch a call (no stats / apply pair), of one
    of four kernels.  NCHW: the cluster kernel, its blocks' sums exchanged
    through distributed shared memory under cluster barriers, or the
    persistent grid.  Channels-minor x: the slab kernel, whose unit is a slab
    of whole groups loaded by cp.async, as a cluster that reads its blocks'
    group sums through distributed shared memory, or as a cooperative grid.
    The grids leave their sums in fixed places of the launch's own scratch
    (from the stream's pool, the counters zeroed in stream order; no static
    device buffer) and meet at integer counters; no scratch argument, no
    float atomics (the only atomics count arrivals, on unsigned integers);
    native.py's signatures agree."""
    import re
    from pathlib import Path

    from gswm_torch import native

    text = (Path(gn.__file__).resolve().parents[1] / "csrc" / "group_norm.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in text.splitlines())
    for used in ("cudaLaunchKernelEx", "cudaLaunchAttributeClusterDimension",
                 "cudaFuncAttributeNonPortableClusterSizeAllowed",
                 "cudaFuncAttributeMaxDynamicSharedMemorySize", "map_shared_rank",
                 "cluster.sync()", "barrier.cluster.arrive", "barrier.cluster.wait",
                 "cp.async.bulk.shared::cluster.global", "cudaLaunchAttributeCooperative",
                 "cudaMallocAsync(&scratch", "cudaMemsetAsync(scratch, 0, count_bytes, st)",
                 "cudaFreeAsync(scratch, st)", "gn_slab_kernel", "cp_async_16_hinted(",
                 "cudaOccupancyMaxActiveClusters", "red.release.gpu.global.add.u32"):
        assert used in code, used
    for gone in ("gn_stats_kernel", "gn_apply_kernel", "partials", "<<<"):
        assert gone not in code, gone
    # the program's build: no buffer in static device memory (the phase
    # stamps' and the column probe are in the measurement build alone)
    program = re.sub(r"#ifdef GN_PHASE_STAMPS.*?#(else|endif)", "", code, flags=re.S)
    assert "__device__ float" not in program and "__device__ unsigned" not in program
    # the atomics count arrivals: the NCHW grid's `arrived` and `passed`, the
    # slab grid's counter (a reduction), all unsigned integers
    assert set(re.findall(r"atomic\w+\(([^,]+),", code)) == {"arrived", "passed"}
    assert "unsigned int* arrived" in code and "unsigned int* passed" in code
    assert re.findall(r"\b(?:red|atom)\.[\w.:]*", program) == ["red.release.gpu.global.add.u32"]
    # one launch site a kernel: the cluster kernel's, the grid's and the slab
    # kernel's two (cluster and grid)
    assert program.count("cudaLaunchKernelEx(") == 4
    # x, weight, bias, out; B, C, HW, G; eps, act, stream
    for name in ("gswm_group_norm", "gswm_group_norm_nhwc", "gswm_group_norm_nhwc_f32"):
        sig = native._SIGNATURES[name]
        assert len(sig) == 11 and sig.count(native._VP) == 5


class _OnCard:
    """Stands in for a tensor on a card, which this machine has not: the
    wrapper's CUDA branch reads a tensor's metadata (its ``requires_grad``
    too) and address alone."""

    device = torch.device("cuda", 0)
    converted = 0
    requires_grad = False

    def __init__(self, shape, dtype, address):
        self.shape, self.dtype, self.address = torch.Size(shape), dtype, address

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return self.address

    def to(self, device=None, dtype=None):
        _OnCard.converted += 1
        return _OnCard(self.shape, dtype, self.address + 4096)

    def contiguous(self):
        return self


def test_wrapper_allocates_only_the_output_and_converts_nothing(monkeypatch):
    """On a CUDA tensor: the argument checks touch no data, fp32 parameters
    pass as they are, the one allocation is the output, and one call of the
    C entry point is one launch on the counter."""
    calls, made = [], []
    monkeypatch.setattr(gn.native, "launch", lambda dev, name, *args: calls.append(
        (dev, name, args)))

    def empty_like(t):
        made.append(t)
        return _OnCard(t.shape, t.dtype, 0x7000)

    monkeypatch.setattr(torch, "empty_like", empty_like)
    monkeypatch.setattr(_OnCard, "converted", 0)
    x = _OnCard((2, 64, 6, 8), torch.bfloat16, 0x1000)
    w = _OnCard((64,), torch.float32, 0x2000)
    b = _OnCard((64,), torch.float32, 0x3000)
    before = gn.fused_group_norm.launches
    out = gn.fused_group_norm(x, w, b, 32, 1e-6, "silu")
    assert gn.fused_group_norm.launches == before + 1
    assert out.address == 0x7000 and made == [x] and _OnCard.converted == 0
    assert calls == [(x.device, "gswm_group_norm",
                      (0x1000, 0x2000, 0x3000, 0x7000, 2, 64, 48, 32, 1e-6, 1))]
    # parameters in another dtype are converted, one copy each
    gn.fused_group_norm(x, _OnCard((64,), torch.bfloat16, 0x4000), b, 32, 1e-6)
    assert _OnCard.converted == 1 and calls[-1][2][1] == 0x4000 + 4096
    assert calls[-1][2][-1] == 0
    # what the kernel does not take is refused before any launch
    with pytest.raises(TypeError):
        gn.fused_group_norm(_OnCard((2, 64, 6, 8), torch.float16, 0x1000), w, b)
    with pytest.raises(ValueError):
        gn.fused_group_norm(_OnCard((2, 64, 6, 8), torch.bfloat16, 0x1008), w, b)
    with pytest.raises(ValueError):
        gn.fused_group_norm(x, _OnCard((32,), torch.float32, 0x2000), b)
    assert len(calls) == 2


class _Strided(_OnCard):
    """A tensor on a card with the strides of ``like``, a CPU tensor: what
    the layout rule reads (strides, a permuted view's contiguity) comes from
    it."""

    def __init__(self, like, address):
        super().__init__(like.shape, like.dtype, address)
        self.like = like

    def is_contiguous(self, **memory_format):
        return self.like.is_contiguous(**memory_format)

    def stride(self, *dim):
        return self.like.stride(*dim)

    def permute(self, *dims):
        return self.like.permute(*dims)

    def element_size(self):
        return self.like.element_size()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
def test_wrapper_routes_each_layout_to_its_entry(monkeypatch, layout, dtype):
    """On a CUDA tensor: x of each layout and dtype reaches the C entry
    ``entry`` names with (x, weight, bias, out, B, C, HW, G, eps, act), the
    output allocated like x, one launch on that pair's counter alone."""
    calls = []
    monkeypatch.setattr(gn.native, "launch", lambda dev, name, *args: calls.append(
        (name, args)))
    monkeypatch.setattr(torch, "empty_like", lambda t: _OnCard(t.shape, t.dtype, 0x7000))
    monkeypatch.setattr(gn, "fused_group_norm_reference", None)  # no fallback
    like = torch.zeros((2, 320, 6, 8), dtype=dtype)
    if layout == "nhwc":
        like = like.contiguous(memory_format=torch.channels_last)
    x = _Strided(like, 0x1000)
    w, b = _OnCard((320,), torch.float32, 0x2000), _OnCard((320,), torch.float32, 0x3000)
    counters = [counter for _, counter in gn.ENTRIES.values()]
    before = {c: getattr(gn.fused_group_norm, c) for c in counters}
    gn.fused_group_norm(x, w, b, 32, 1e-6, "silu")
    assert calls == [(gn.entry(layout, dtype),
                      (0x1000, 0x2000, 0x3000, 0x7000, 2, 320, 48, 32, 1e-6, 1))]
    moved = {c: getattr(gn.fused_group_norm, c) - n for c, n in before.items()}
    assert moved == {c: int(c == gn.ENTRIES[layout, dtype][1]) for c in counters}
    # other strides, and channels-minor x whose groups are wider than a slab
    # the kernel takes, are refused before any launch; channels-minor x of
    # any C above 4096 whose groups are narrow is taken
    with pytest.raises(ValueError, match="neither contiguous"):
        gn.fused_group_norm(_Strided(torch.zeros((2, 320, 6, 8), dtype=dtype)[..., :4],
                                     0x1000), w, b)
    wide = torch.zeros((1, 8320, 2, 2), dtype=dtype).contiguous(memory_format=torch.channels_last)
    big = _OnCard((8320,), torch.float32, 0x2000)
    with pytest.raises(ValueError, match="wider than"):
        gn.fused_group_norm(_Strided(wide, 0x1000), big, big, groups=1)
    assert len(calls) == 1
    if layout == "nhwc":
        gn.fused_group_norm(_Strided(wide, 0x1000), big, big, groups=32)
        assert calls[-1][0] == gn.entry(layout, dtype) and calls[-1][1][5] == 8320


# (C, groups, itemsize, taken): any C whose groups a slab holds; the widest
# group of 16-byte vectors (4096 bf16 or 2048 float32 channels) and one past
# it; rows that are no 16-byte vectors, up to 512 channels a group; a group
# of 16-byte vectors only in pairs (520 bytes: two make 1040)
SLAB_CASES = [(320, 32, 2, True), (2560, 32, 4, True), (8320, 32, 2, True),
              (131072, 32, 2, True), (131104, 32, 2, False), (65536, 32, 4, True),
              (65568, 32, 4, False), (4096, 1, 2, True), (4104, 1, 2, False),
              (8320, 1, 2, False), (38, 2, 2, True), (1024, 2, 2, True), (1026, 2, 2, False),
              (8320, 32, 4, True), (16384, 2, 4, False)]


@pytest.mark.parametrize("c,groups,itemsize,taken", SLAB_CASES)
def test_nhwc_slab_rule_takes_any_c_whose_groups_a_slab_holds(c, groups, itemsize, taken):
    """``nhwc_slab_fits`` against the slab kernel's rule (csrc/group_norm.cu
    pick_slab): the fewest whole groups whose column is 16-byte vectors fit
    512 threads of 16 bytes (8192 bytes a pixel), or, where C * itemsize %
    16 != 0, a group of at most 512 channels; C itself is not capped."""
    assert gn.nhwc_slab_fits(c, groups, itemsize) is taken


def test_wrapper_refuses_a_gradient_before_any_launch(monkeypatch):
    """On a CUDA tensor under grad mode, an input that requires grad raises
    (the kernel has no backward) before anything is launched or allocated,
    and nothing falls back to the plain version; under no_grad it launches."""
    calls = []
    monkeypatch.setattr(gn.native, "launch", lambda dev, name, *args: calls.append(name))
    monkeypatch.setattr(torch, "empty_like", lambda t: _OnCard(t.shape, t.dtype, 0x7000))
    monkeypatch.setattr(gn, "fused_group_norm_reference", None)  # no fallback
    x = _OnCard((2, 64, 6, 8), torch.bfloat16, 0x1000)
    w = _OnCard((64,), torch.float32, 0x2000)
    w.requires_grad = True
    b = _OnCard((64,), torch.float32, 0x3000)
    before = gn.fused_group_norm.launches
    with pytest.raises(RuntimeError, match="fused_group_norm.*no backward|fused_group_norm.*"
                                           "neither gswm nor gswm_torch has a backward"):
        gn.fused_group_norm(x, w, b, 32, 1e-6, "silu")
    assert calls == [] and gn.fused_group_norm.launches == before
    with torch.no_grad():
        gn.fused_group_norm(x, w, b, 32, 1e-6, "silu")
    assert calls == ["gswm_group_norm"]
