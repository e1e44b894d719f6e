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
