"""PyTorch port vs the JAX package: self-attention kernels' plain versions.

On the CPU the port's wrappers run their plain PyTorch versions; these must
match the JAX package's Pallas kernels (fused-qkv, split flash and cres, in
interpret mode) and its plain attention at fp32 tolerance.  The CUDA kernels themselves run only on
the card: tests/test_torch_gpu.py compares them with the plain versions
there.

Softmax semantics: the port computes exact softmax (the TPU kernels'
``use_max`` branch).  The TPU bf16 path clamps logits at 60 and drops the
running max; the two agree while |logit| < 60 and differ above it, which
``test_exact_softmax_differs_from_clamped_xla_flash_above_60`` pins.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gswm.ops.attention import (
    flash_attention as j_flash_attention,
    flash_attention_cres,
    flash_attention_fused_qkv,
    reference_attention,
    xla_flash_attention,
)
from gswm_torch.models.layers import Attention
from gswm_torch.ops import attention as attn

torch.set_num_threads(2)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("b,s,c,h,d", [
    # pinned ragged shapes of tests/test_fused_qkv_attention.py:26-35
    (1, 640, 96, 3, 64),
    (1, 2304, 128, 2, 64),
])
def test_fused_qkv_reference_matches_jax_kernel(b, s, c, h, d):
    x = _rand((b, s, c), 0)
    wq, wk, wv = (_rand((c, h * d), i, 0.1) for i in (1, 2, 3))
    want = np.asarray(flash_attention_fused_qkv(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(wk), jnp.asarray(wv), h, d,
        interpret=True))
    before = attn.fused_qkv_attention.launches
    # the port takes torch.nn.Linear's (out, in) weight layout
    got = attn.fused_qkv_attention(
        torch.from_numpy(x), *(torch.from_numpy(w.T.copy()) for w in (wq, wk, wv)),
        h)
    assert attn.fused_qkv_attention.launches == before  # CPU: plain version
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("c,d", [(640, 80), (1280, 160)])
def test_fused_qkv_reference_matches_jax_kernel_at_sd14_head_dims(c, d):
    """SD 1.x's levels 1 and 2 (256 tokens of 640 channels, 8 heads of 80;
    of 1280, 8 heads of 160) in bf16, where the Pallas kernel's VMEM gate
    admits them (fused_qkv_attention_fits), in interpret mode.  C^-0.5-scale
    weights keep q, k and v ~N(0, 1) and the logits far below the TPU
    path's clamp at 60; the kernel rounds q, k, v and p to bf16, the plain
    version only its output: atol 4e-2, the bf16 bound of the tests below."""
    b, s, h = 1, 256, 8
    x = _rand((b, s, c), 30)
    wq, wk, wv = (_rand((c, h * d), i, c**-0.5) for i in (31, 32, 33))
    jx, jq, jk, jv = (jnp.asarray(t, jnp.bfloat16) for t in (x, wq, wk, wv))
    want = np.asarray(flash_attention_fused_qkv(jx, jq, jk, jv, h, d, interpret=True))
    got = attn.fused_qkv_attention(
        *(torch.from_numpy(np.array(t.astype(jnp.float32))).bfloat16()
          for t in (jx, jq.T, jk.T, jv.T)), h)
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, h * d)
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), atol=4e-2)


@pytest.mark.parametrize("b,s,h", [(2, 300, 2), (1, 513, 3), (1, 2305, 1)])
def test_flash_reference_matches_jax_reference(b, s, h):
    d = 64
    q, k, v = (_rand((b, s, h * d), i) for i in range(3))
    want = np.asarray(reference_attention(
        *(jnp.asarray(t).reshape(b, s, h, d) for t in (q, k, v)))).reshape(
            b, s, h * d)
    before = attn.flash_attention.launches
    got = attn.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)), h)
    assert attn.flash_attention.launches == before
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    np.testing.assert_allclose(
        got.numpy(),
        np.asarray(xla_flash_attention(*(jnp.asarray(t) for t in (q, k, v)),
                                       h, d)), atol=2e-5)


@pytest.mark.parametrize("b,s,h,d", [(2, 300, 8, 40), (1, 4096, 8, 40), (1, 1001, 3, 80),
                                     (1, 513, 2, 160)])
def test_flash_reference_matches_xla_flash_at_sd14_head_dims(b, s, h, d):
    """The natural-layout plain version at SD 1.x's head dims (level 0: 8
    heads of 40 at 4096 tokens) against ``xla_flash_attention``, fp32 with
    unit-scale inputs (logits far below the TPU path's clamp at 60): atol
    2e-5 as at 64."""
    q, k, v = (_rand((b, s, h * d), 20 + i) for i in range(3))
    want = np.asarray(xla_flash_attention(*(jnp.asarray(t) for t in (q, k, v)), h, d))
    got = attn.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)), h)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("d,width", [(8, 64), (16, 64), (40, 64), (56, 64), (64, 64),
                                     (72, 128), (80, 128), (128, 128), (136, 192),
                                     (160, 192), (320, 320), (504, 512), (512, 512)])
def test_kernel_head_dim_takes_multiples_of_8_up_to_512(d, width):
    """The panel width the kernels compute a head dim at: one 64-column
    panel up to 64 (flash_hopper.cu), whole panels above (flash_split.cu)."""
    assert attn.kernel_head_dim(d) == width


@pytest.mark.parametrize("d", [0, 4, 12, 36, 100, 513, 520, 576, 1024])
def test_kernel_head_dim_refuses_the_rest(d):
    with pytest.raises(ValueError, match="d % 8 == 0"):
        attn.kernel_head_dim(d)


def test_exact_softmax_differs_from_clamped_xla_flash_above_60():
    """bf16, one query row with logits 80 and 70: exact softmax puts ~all
    weight on the 80 key; the TPU no-max path clamps both to 60 and splits
    the weight.  Every other row (|logit| < 60) agrees within bf16 rounding."""
    s, d = 128, 64
    q = _rand((1, s, d), 0)
    k = _rand((1, s, d), 1, 0.1)
    v = _rand((1, s, d), 2)
    q[0, 0] = 0.0
    q[0, 0, 0], q[0, 0, 1] = 80.0, 70.0
    k[0, 5], k[0, 9] = 0.0, 0.0
    k[0, 5, 0], k[0, 9, 1] = 8.0, 8.0  # logits 80 and 70 after the 1/8 scale
    v[0, 5], v[0, 9] = 1.0, -1.0
    tq, tk, tv = (torch.from_numpy(t).bfloat16() for t in (q, k, v))
    ours = attn.flash_attention(tq, tk, tv, 1).float().numpy()
    clamped = np.asarray(xla_flash_attention(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (tq, tk, tv)),
        1, d)).astype(np.float32)
    np.testing.assert_allclose(ours[0, 0], 1.0, atol=1e-2)
    assert np.abs(ours[0, 0] - clamped[0, 0]).min() > 0.5
    np.testing.assert_allclose(ours[0, 1:], clamped[0, 1:], atol=4e-2)


@pytest.mark.parametrize("seq,route", [
    (64, "plain"), (77, "plain"), (255, "plain"), (256, "fused_qkv"),
    (1024, "fused_qkv"), (2304, "fused_qkv"), (2305, "xf"), (4096, "xf")])
def test_routing_window(seq, route):
    """With no switch set: the JAX package's default window."""
    assert attn.route_self_attention(seq) == route


@pytest.mark.parametrize("seq", [64, 256, 2305])
def test_attention_module_routes_match_plain(seq):
    """The module's three self-attention routes give the same fp32 result."""
    torch.manual_seed(0)
    mod = Attention(128, 128, 2, 64)
    x = torch.randn(1, seq, 128)
    want = attn.fused_qkv_attention_reference(
        x, mod.to_q.weight, mod.to_k.weight, mod.to_v.weight, 2)
    with torch.no_grad():
        got = mod(x)
        want = mod.to_out(want)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_wrappers_reject_other_devices():
    t = torch.empty((1, 256, 64), device="meta")
    w = torch.empty((64, 64), device="meta")
    with pytest.raises(ValueError):
        attn.flash_attention(t, t, t, 1)
    with pytest.raises(ValueError):
        attn.fused_qkv_attention(t, w, w, w, 1)


@pytest.mark.parametrize("b,sq,sk,h,d", [
    (1, 1024, 1024, 1, 512),  # the VAE mid shape of tests/test_ops_attention.py:78-88
    (2, 700, 700, 3, 64),  # ragged, several heads
    (1, 300, 77, 2, 64),  # 77 keys: the einsum branch on both sides
    # the widths the CUDA kernel splits across its two consumer warpgroups
    # (two panels of 64 columns, and three: 2 + 1), ragged, Sq != Sk
    (2, 130, 577, 2, 128),
    (1, 333, 1030, 2, 192),
    # widths off the 64-column panels: SD 1.x's 80 and 160, and 72
    (2, 130, 577, 2, 80),
    (1, 70, 512, 2, 160),
    (1, 100, 600, 3, 72),
])
def test_split_matches_jax_flash_attention(b, sq, sk, h, d):
    """fp32, atol/rtol 3e-5 (the bound of tests/test_ops_attention.py:87)."""
    q = _rand((b, sq, h, d), 0)
    k, v = _rand((b, sk, h, d), 1), _rand((b, sk, h, d), 2)
    want = np.asarray(j_flash_attention(
        *(jnp.asarray(t) for t in (q, k, v)), interpret=True))
    before = attn.flash_attention_split.launches
    got = attn.flash_attention_split(*(torch.from_numpy(t) for t in (q, k, v)))
    assert attn.flash_attention_split.launches == before  # CPU: plain version
    assert got.shape == (b, sq, h, d)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=3e-5)
    if sk >= attn.SPLIT_MIN_KEYS:
        torch.testing.assert_close(
            got, attn.flash_attention_split_reference(
                *(torch.from_numpy(t) for t in (q, k, v))), rtol=0, atol=0)


def test_split_exact_softmax_differs_from_clamped_jax_flash_above_60():
    """bf16 at 512 keys (the blockwise path on both sides), one query row
    with logits 80 and 70: the port's exact softmax puts ~all weight on the
    80 key; the TPU no-max path clamps both to 60 and splits the weight.
    Rows with |logit| < 60 agree within bf16 rounding."""
    s, d = 512, 64
    q = _rand((1, s, 1, d), 0)
    k = _rand((1, s, 1, d), 1, 0.1)
    v = _rand((1, s, 1, d), 2)
    q[0, 0, 0] = 0.0
    q[0, 0, 0, 0], q[0, 0, 0, 1] = 80.0, 70.0
    k[0, 5, 0], k[0, 9, 0] = 0.0, 0.0
    k[0, 5, 0, 0], k[0, 9, 0, 1] = 8.0, 8.0  # logits 80 and 70 after 1/8
    v[0, 5, 0], v[0, 9, 0] = 1.0, -1.0
    tq, tk, tv = (torch.from_numpy(t).bfloat16() for t in (q, k, v))
    ours = attn.flash_attention_split(tq, tk, tv).float().numpy()
    clamped = np.asarray(j_flash_attention(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (tq, tk, tv)),
        interpret=True)).astype(np.float32)
    np.testing.assert_allclose(ours[0, 0, 0], 1.0, atol=1e-2)
    assert np.abs(ours[0, 0, 0] - clamped[0, 0, 0]).min() > 0.5
    np.testing.assert_allclose(ours[0, 1:], clamped[0, 1:], atol=4e-2)


@pytest.mark.parametrize("b,s,h", [(1, 300, 1), (2, 1000, 3)])
def test_cres_is_served_by_the_flash_plain_version(b, s, h):
    """The Pallas ``flash_attention_cres`` (K/V channels zero-padded to a
    multiple of 128, ragged S) computes what the port's natural-layout
    flash kernel's plain version does: fp32, atol 2e-5 as the K2 parity
    test above."""
    d = 64
    q, k, v = (_rand((b, s, h * d), i) for i in range(3))
    pad = (-(h * d)) % 128
    kp, vp = (np.pad(t, ((0, 0), (0, 0), (0, pad))) for t in (k, v))
    want = np.asarray(flash_attention_cres(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), h, d, interpret=True))
    got = attn.flash_attention_reference(*(torch.from_numpy(t) for t in (q, k, v)), h)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_split_rejects_mismatched_shapes():
    q = torch.zeros((1, 600, 2, 64))
    with pytest.raises(ValueError):
        attn.flash_attention_split(q, q[:, :, :1], q[:, :, :1])  # heads differ
    with pytest.raises(ValueError):
        attn.flash_attention_split(q, q, q[:, :500])  # k and v lengths differ
    with pytest.raises(ValueError):
        attn.flash_attention_split(q[0], q[0], q[0])  # not 4-d
    t = torch.empty((1, 600, 1, 64), device="meta")
    with pytest.raises(ValueError):
        attn.flash_attention_split(t, t, t)  # neither CPU nor CUDA


@pytest.mark.parametrize("b,s,c,h", [(1, 300, 128, 2), (2, 77, 64, 3)])
def test_qkv_projection_then_flash_matches_jax_fused_kernel(b, s, c, h):
    """K1 is its projection GEMM followed by the D = 64 flash kernel: the
    two wrappers' plain versions, chained, give the Pallas fused-qkv
    kernel's output (interpret mode), and the projection alone gives
    x @ w as jax computes it."""
    d = 64
    x = _rand((b, s, c), 10)
    wq, wk, wv = (_rand((c, h * d), i, 0.1) for i in (11, 12, 13))
    before = attn.qkv_projection.launches
    q, k, v = attn.qkv_projection(
        torch.from_numpy(x), *(torch.from_numpy(w.T.copy()) for w in (wq, wk, wv)))
    assert attn.qkv_projection.launches == before  # CPU: plain version
    for got, w in zip((q, k, v), (wq, wk, wv)):
        assert tuple(got.shape) == (b, s, h * d)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jnp.einsum("bsc,cn->bsn", jnp.asarray(x),
                                               jnp.asarray(w))), atol=2e-5)
    want = np.asarray(flash_attention_fused_qkv(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(wk), jnp.asarray(wv), h, d,
        interpret=True))
    np.testing.assert_allclose(attn.flash_attention(q, k, v, h).numpy(), want,
                               atol=2e-5)
