"""The float32 kernels' arithmetic on the CPU: 3xTF32 products and the key
split of csrc/flash_f32.cu, through their plain models in
gswm_torch.ops.attention (``split_tf32``, ``flash_attention_3xtf32_reference``,
``f32_key_splits``).

This machine has no card: the kernels themselves are held to float64 on the
card (tests/test_torch_gpu.py, chip_smoke.py phase 13a).  Here the models say
what the kernels' design should reach: the split keeps about 21 bits, three
products meet the float32 bound of 1e-5 of max |want| against float64 where
one TF32 product misses it, and the key split with its combine is the same
function as one pass over the keys, the JAX flash kernel's (interpret mode,
as the JAX package's own tests run it).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gswm.ops.attention import flash_attention as j_flash_attention
from gswm_torch.ops import attention as attn

F32_BOUND = 1e-5  # chip_smoke.py F32_REL_BOUND: the float32 bound of max |want|
H100_SMS = 132


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel(got, want):
    want = want.double()
    return ((got.double() - want).abs().max() / want.abs().max()).item()


def _f64_attention(q, k, v):
    """(B, Sq, H, D) softmax(q k^T d^-0.5) v and its log-sum-exp in float64."""
    d = q.shape[-1]
    qd, kd, vd = (t.double().transpose(1, 2) for t in (q, k, v))
    logits = qd @ kd.transpose(-1, -2) * d**-0.5
    return (torch.softmax(logits, -1) @ vd).transpose(1, 2), torch.logsumexp(logits, -1)


def _tf32_nearest(x: np.ndarray) -> np.ndarray:
    """x rounded to 10 explicit mantissa bits in float64, to nearest, ties
    away from zero: the rounding cvt.rna.tf32.f32 makes (normal x)."""
    m, e = np.frexp(x.astype(np.float64))  # x = m 2^e, 0.5 <= |m| < 1
    scaled = np.abs(m) * 2**11
    return np.sign(m) * np.floor(scaled + 0.5) / 2**11 * 2.0**e


@pytest.mark.parametrize("scale", [1e-20, 1e-3, 1.0, 7.0, 1e20])
def test_split_tf32_big_part_is_tf32_rounded_to_nearest(scale):
    """big keeps 10 explicit mantissa bits (the low 13 bits of its pattern
    are zero), rounded to nearest with ties away from zero; small is x -
    big rounded the same way; on signed normal inputs across the range."""
    x = torch.from_numpy(_rand(20000, 1) * scale)
    x[:4] = torch.tensor([1 + 2**-11, -(1 + 2**-11), 1 + 3 * 2**-11, 2**-11]) * scale  # ties
    big, small = attn.split_tf32(x)
    assert big.dtype == small.dtype == torch.float32
    assert not (big.view(torch.int32) & 0x1FFF).any()
    assert not (small.view(torch.int32) & 0x1FFF).any()
    np.testing.assert_array_equal(big.numpy().astype(np.float64), _tf32_nearest(x.numpy()))
    np.testing.assert_array_equal(small.numpy().astype(np.float64),
                                  _tf32_nearest((x - big).numpy()))
    assert torch.equal(big.abs(), attn.split_tf32(-x)[0].abs())


def test_split_tf32_keeps_22_bits():
    """|x - big - small| <= 2^-22 |x| on signed inputs whose small part is
    normal (|x| >= 2^-100, every exponent up to 2^100); on subnormal inputs,
    and normal ones so small that small's part is subnormal, the residual is
    below 2^-22 |x| + 2^-137 (small then rounds at the subnormal spacing,
    2^13 of 2^-149), the split exact in float64 terms all the same."""
    g = np.random.default_rng(2)
    exps = g.integers(-100, 100, 50000)
    x = torch.from_numpy((g.standard_normal(50000) * 2.0**exps).astype(np.float32))
    big, small = attn.split_tf32(x)
    res = (x.double() - big.double() - small.double()).abs()
    assert (res <= 2**-22 * x.double().abs()).all()
    tiny = torch.from_numpy(np.concatenate([
        g.integers(1, 2**23, 20000) * 2.0**-149,          # subnormal
        -g.integers(1, 2**23, 20000) * 2.0**-149,
        g.standard_normal(20000) * 2.0**-120]).astype(np.float32))
    assert (tiny.abs() < 2**-126).sum() >= 40000
    big, small = attn.split_tf32(tiny)
    res = (tiny.double() - big.double() - small.double()).abs()
    assert (res <= 2**-22 * tiny.double().abs() + 2**-137).all()
    assert (big.double() + small.double() - tiny.double()).abs().max() <= 2**-137


@pytest.mark.parametrize("b,sq,sk,h,d", [(1, 100, 300, 2, 64), (2, 70, 130, 1, 80),
                                         (1, 64, 577, 1, 160), (1, 33, 200, 2, 40)])
def test_3xtf32_model_meets_the_float32_bound_and_tf32_misses_it(b, sq, sk, h, d):
    """The 3xTF32 model of the core within F32_BOUND of float64 at small
    shapes, split or not; the same model on one TF32 product a term misses
    it (so the bound tells 3xTF32 from TF32)."""
    q = torch.from_numpy(_rand((b, sq, h, d), 3 + d))
    k, v = (torch.from_numpy(_rand((b, sk, h, d), s + d)) for s in (4, 5))
    want, _ = _f64_attention(q, k, v)
    for splits in (1, 2):
        assert _rel(attn.flash_attention_3xtf32_reference(q, k, v, splits), want) <= F32_BOUND
        assert _rel(attn.flash_attention_3xtf32_reference(q, k, v, splits, passes=1),
                    want) > F32_BOUND


def test_3xtf32_model_at_16384_keys_and_d_512():
    """One 64-row block of (1, 16384, 1, 512), the VAE's mid attention at
    1024x1024 and the widest sum the core runs: the model, with the key
    split the design takes at that shape and its sum order (logits a
    64-column panel at a time, each key tile's p v apart), predicts an error
    below F32_BOUND of float64; one TF32 product misses it."""
    sk, d = 16384, 512
    q = torch.from_numpy(_rand((1, 64, 1, d), 6))
    k, v = (torch.from_numpy(_rand((1, sk, 1, d), s)) for s in (7, 8))
    splits = attn.f32_key_splits(1, sk, sk, 1, d, H100_SMS)
    want, want_lse = _f64_attention(q, k, v)
    got, lse = attn.flash_attention_3xtf32_reference(q, k, v, splits, return_lse=True)
    err = _rel(got, want)
    tf32 = _rel(attn.flash_attention_3xtf32_reference(q, k, v, splits, passes=1), want)
    print(f"(1, 16384, 1, 512), one 64-row block, s = {splits}: the 3xTF32 model's "
          f"err/max|want| {err:.3e} (bound {F32_BOUND:.0e}), one TF32 product {tf32:.3e}, "
          f"lse err {(lse.double() - want_lse).abs().max().item():.3e}")
    assert err <= F32_BOUND < tf32
    assert (lse.double() - want_lse).abs().max().item() <= F32_BOUND * max(
        1.0, want_lse.abs().max().item())


def test_3xtf32_gemm_model_at_level_1():
    """The projection GEMM at (M, C, N) = (4096, 640, 640), SD 2.x's level 1
    at batch 4: three TF32 products a term (``split_tf32``'s parts, fp32
    sums) within F32_BOUND of float64; one misses it."""
    x = torch.from_numpy(_rand((4096, 640), 9))
    w = torch.from_numpy(_rand((640, 640), 10))
    want = x.double() @ w.double().t()
    xs, ws = attn.split_tf32(x), [t.t() for t in attn.split_tf32(w)]
    assert _rel(attn._products_3xtf32(xs, ws, 3), want) <= F32_BOUND
    assert _rel(attn._products_3xtf32(xs, ws, 1), want) > F32_BOUND


@pytest.mark.parametrize("splits,sk", [(1, 600), (2, 600), (3, 600), (3, 530)])
def test_key_split_algebra_matches_one_pass_and_jax(splits, sk):
    """The key split's plain model (fp32 products: partial o, m, l a chunk
    of whole 64-key tiles, then the combine's merge) against the unsplit
    plain version (within 1e-6 of max |want|, lse too) and the JAX
    ``flash_attention`` (Pallas, interpret mode) and ``jax.nn.logsumexp`` of
    the JAX logits; s = 1, 2, 3, and 530 keys (9 tiles, the last ragged: 3
    chunks of 3 tiles, the last 18 keys short)."""
    b, sq, h, d = 1, 70, 2, 64
    q = _rand((b, sq, h, d), 11)
    k, v = _rand((b, sk, h, d), 12), _rand((b, sk, h, d), 13)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    got, lse = attn.flash_attention_3xtf32_reference(tq, tk, tv, splits, passes=0,
                                                     return_lse=True)
    one, one_lse = attn.flash_attention_split_lse_reference(tq, tk, tv)
    assert _rel(got, one) <= 1e-6
    assert (lse - one_lse).abs().max().item() <= 1e-6 * max(1.0, one_lse.abs().max().item())
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    want = np.asarray(j_flash_attention(jq, jk, jv, interpret=True))
    want_lse = np.asarray(jax.nn.logsumexp(
        jnp.einsum("bqhd,bkhd->bhqk", jq, jk) * d**-0.5, axis=-1))
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5, rtol=0)
    tiles = math.ceil(sk / attn.F32_KEY_TILE)
    assert math.ceil(tiles / math.ceil(tiles / splits)) == splits  # no chunk empty


@pytest.mark.parametrize("shape", [(4, 4096, 4096, 5, 64), (4, 1024, 1024, 8, 80),
                                   (1, 16384, 16384, 1, 512), (4, 4096, 4096, 8, 40),
                                   (2, 16384, 16384, 1, 512), (4, 256, 256, 8, 160)])
def test_key_splits_one_where_the_waves_are_full(shape):
    """s = 1 where no wave of blocks is under half full: (4, 4096, 5, 64)
    is 640 blocks of 128 rows, 4.85 waves on 132 SMs; and where a chunk of
    two tiles or more would be under F32_MIN_CHUNK_TILES: (4, 256, 8, 160)
    has 4 key tiles, so its half wave stays unsplit."""
    assert attn.f32_key_splits(*shape, H100_SMS) == 1


@pytest.mark.parametrize("shape", [(1, 9216, 9216, 1, 512), (2, 9216, 9216, 1, 512),
                                   (2, 4096, 4096, 5, 64), (2, 1001, 577, 3, 72),
                                   (4, 1024, 1024, 10, 64)])
def test_key_splits_fill_part_full_waves(shape):
    """Where the waves of unsplit blocks leave one under half full, s > 1
    and no wave of the split grid is under half full: (1, 9216, 1, 512) is
    144 blocks of 64 rows, a full wave and 12 blocks; split, every chunk
    whole tiles, none empty and none under F32_MIN_CHUNK_TILES tiles, s at
    most F32_MAX_SPLITS."""
    b, sq, sk, h, d = shape
    s = attn.f32_key_splits(*shape, H100_SMS)
    rows = attn.F32_WIDE_ROWS if d > 256 else attn.F32_BLOCK_ROWS
    blocks = math.ceil(sq / rows) * h * b
    assert 1 < s <= attn.F32_MAX_SPLITS
    last = blocks * s % H100_SMS
    assert last == 0 or 2 * last >= H100_SMS, (s, blocks * s)
    tiles = math.ceil(sk / attn.F32_KEY_TILE)
    assert math.ceil(tiles / math.ceil(tiles / s)) == s
    assert math.ceil(tiles / s) >= attn.F32_MIN_CHUNK_TILES
    if shape == (1, 9216, 9216, 1, 512):
        assert blocks == 144 and s == 9


def test_key_splits_depend_on_the_shape_alone():
    """The packed form's heads of 64, the transposed form and the natural
    one at one shape take one s (f32_key_splits sees no form), and the
    scratch and workspace sizes follow the shape: 4 B H Skp Dp and s B H Sq
    (d + 2) floats."""
    for shape in [(2, 9216, 9216, 5, 64), (1, 1001, 1001, 3, 64), (2, 577, 577, 2, 160)]:
        assert len({attn.f32_key_splits(*shape, H100_SMS) for _ in range(3)}) == 1
    assert attn.f32_scratch_numel(1, 577, 2, 160) == 4 * 1 * 2 * 640 * 192
    assert attn.f32_workspace_numel(3, 2, 100, 5, 64) == 3 * 2 * 5 * 100 * 66
