"""PyTorch port vs the JAX package: the fused GroupNorm op (K8).

The port's ``fused_group_norm`` takes NCHW, the JAX op NHWC; inputs come
from a numpy seed and are transposed at the boundary.  On the CPU the port
runs its plain version, which must match the Pallas kernel in interpret mode
in both its layouts (resident, twopass), with and without the fused SiLU, at
both epsilons the models use: fp32, atol 2e-5 (the bound of
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
    """csrc/group_norm.cu: one cluster kernel (no stats / apply pair), the
    sums exchanged through distributed shared memory under cluster barriers,
    no scratch argument, no float atomics; native.py's signature agrees."""
    from pathlib import Path

    from gswm_torch import native

    text = (Path(gn.__file__).resolve().parents[1] / "csrc" / "group_norm.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in text.splitlines())
    for used in ("cudaLaunchKernelEx", "cudaLaunchAttributeClusterDimension",
                 "cudaFuncAttributeNonPortableClusterSizeAllowed",
                 "cudaFuncAttributeMaxDynamicSharedMemorySize", "map_shared_rank",
                 "cluster.sync()", "barrier.cluster.arrive", "barrier.cluster.wait",
                 "cp.async.bulk.shared::cluster.global"):
        assert used in code, used
    for gone in ("gn_stats_kernel", "gn_apply_kernel", "partials", "atomicAdd", "<<<"):
        assert gone not in code, gone
    assert code.count("cudaLaunchKernelEx(") == 1
    # x, weight, bias, out; B, C, HW, G; eps, act, stream
    sig = native._SIGNATURES["gswm_group_norm"]
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
        gn.fused_group_norm(_OnCard((2, 64, 6, 8), torch.float32, 0x1000), w, b)
    with pytest.raises(ValueError):
        gn.fused_group_norm(_OnCard((2, 64, 6, 8), torch.bfloat16, 0x1008), w, b)
    with pytest.raises(ValueError):
        gn.fused_group_norm(x, _OnCard((32,), torch.float32, 0x2000), b)
    assert len(calls) == 2


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
