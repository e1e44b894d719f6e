"""PyTorch port vs the JAX package: the self-attention tiers behind the JAX
package's ``GSWM_*`` switches.

  * K6 (``flash_attention_packed``), K7 (``flash_attention_transposed``) and
    K1 in the JAX package's seqhead layout (K5): the port's plain versions
    against the Pallas kernels in interpret mode, fp32, atol 2e-5 (the
    bound of tests/test_packed_attention.py and
    tests/test_transposed_attention.py).
  * Above |logit| 60 in bf16 the port's exact softmax differs from the
    Pallas kernels' clamped no-max softmax; below it they agree within bf16
    rounding (atol 4e-2, as tests/test_torch_attention.py).
  * The port's route against the JAX ``Attention`` predicates on the sd-2-1
    shapes under each switch set, with the documented divergences.
  * The port's ``Attention`` on bridged weights against the JAX module under
    ``GSWM_FORCE_FLASH=1`` and each switch set.

On the CPU every wrapper runs its plain version; the CUDA kernels are held
against those on the card (tests/test_torch_gpu.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gswm.models.layers import Attention as JAttention
from gswm.ops.attention import (
    flash_attention_fused_qkv,
    flash_attention_packed,
    flash_attention_transposed,
    reference_attention,
)
from gswm_torch.models import bridge
from gswm_torch.models.layers import Attention
from gswm_torch.ops import attention as attn

torch.set_num_threads(2)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)


def _pack(q, k, v, pairs):
    """(B, S, H, 64) each -> (B, S, 3 * pairs * 128), the packed lane layout
    (tests/test_packed_attention.py:26-35)."""
    b, s, h, d = q.shape

    def flat_pad(t):
        return np.pad(t.reshape(b, s, h * d), ((0, 0), (0, 0), (0, pairs * 128 - h * d)))

    return np.concatenate([flat_pad(q), flat_pad(k), flat_pad(v)], axis=-1)


def _to_t(q, k, v):
    """(B, S, H, D) each -> (3 * H * D, B, S), head-major
    (tests/test_transposed_attention.py:26-34)."""
    b, s, h, d = q.shape
    return np.concatenate(
        [t.transpose(2, 3, 0, 1).reshape(h * d, b, s) for t in (q, k, v)], axis=0)


@pytest.mark.parametrize("b,s,h", [
    # the shapes of tests/test_packed_attention.py:38-43
    (2, 256, 2),    # even heads: packed layout == natural layout
    (1, 256, 3),    # odd heads: zero-padded pair half
    (1, 300, 2),    # ragged sequence
    (1, 512, 5),    # the SD level-0 head count
])
def test_packed_reference_matches_jax_kernel(b, s, h):
    q, k, v = (_rand((b, s, h, 64), i) for i in range(3))
    pairs = -(-h // 2)
    qkv = _pack(q, k, v, pairs)
    want = np.asarray(flash_attention_packed(jnp.asarray(qkv), 64, interpret=True))
    before = attn.flash_attention_packed.launches
    got = attn.flash_attention_packed(torch.from_numpy(qkv)).numpy()
    assert attn.flash_attention_packed.launches == before  # CPU: plain version
    assert got.shape == (b, s, pairs * 128)
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_array_equal(got[:, :, h * 64:], 0.0)  # the pad head


@pytest.mark.parametrize("b,s,h", [(2, 256, 2), (1, 640, 3), (1, 2304, 2)])
def test_transposed_reference_matches_jax_kernel(b, s, h):
    q, k, v = (_rand((b, s, h, 64), 10 + i) for i in range(3))
    qkv_t = _to_t(q, k, v)
    want = np.asarray(flash_attention_transposed(jnp.asarray(qkv_t), h, 64,
                                                 interpret=True))
    before = attn.flash_attention_transposed.launches
    got = attn.flash_attention_transposed(torch.from_numpy(qkv_t), h).numpy()
    assert attn.flash_attention_transposed.launches == before
    assert got.shape == (h * 64, b, s)
    np.testing.assert_allclose(got, want, atol=2e-5)
    # and both are plain attention on the (B, S, H, D) views
    ref = np.asarray(reference_attention(q, k, v)).transpose(2, 3, 0, 1)
    np.testing.assert_allclose(got, ref.reshape(h * 64, b, s), atol=2e-5)


@pytest.mark.parametrize("b,s,c,h", [(1, 640, 96, 3), (2, 256, 128, 2)])
def test_fused_qkv_reference_matches_jax_seqhead_kernel(b, s, c, h, monkeypatch):
    """K5, the Pallas seqhead layout of the fused-qkv kernel, computes what
    K1's plain version does: K1 serves it."""
    monkeypatch.setenv("GSWM_FUSED_QKV_MODE", "seqhead")
    flash_attention_fused_qkv._clear_cache()  # the mode is read at trace time
    x = _rand((b, s, c), 20)
    wq, wk, wv = (_rand((c, h * 64), 21 + i, 0.1) for i in range(3))
    try:
        want = np.asarray(flash_attention_fused_qkv(
            *(jnp.asarray(t) for t in (x, wq, wk, wv)), h, 64, interpret=True))
    finally:
        flash_attention_fused_qkv._clear_cache()
    got = attn.fused_qkv_attention(
        torch.from_numpy(x), *(torch.from_numpy(w.T.copy()) for w in (wq, wk, wv)), h)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def _logits_above_60(q, k, v, row_q, row_k):
    """One query row with logits 80 and 70 (after the 1/8 scale) on keys 5
    and 9, whose values are +1 and -1; q, k, v are (..., 64) slices."""
    q[row_q] = 0.0
    q[row_q + (0,)], q[row_q + (1,)] = 80.0, 70.0
    for j, col in ((5, 0), (9, 1)):
        k[row_k(j)] = 0.0
        k[row_k(j) + (col,)] = 8.0
    v[row_k(5)], v[row_k(9)] = 1.0, -1.0


def test_packed_exact_softmax_differs_from_clamped_jax_kernel_above_60():
    """bf16, 512 tokens, heads 0 and 1 of one pair: in head 0's row 0 the
    port's exact softmax puts ~all weight on the 80 key; the Pallas no-max
    path clamps both logits to 60 and splits the weight.  Every other row
    and head agrees within bf16 rounding."""
    s = 512
    q, k, v = _rand((1, s, 2, 64), 0), _rand((1, s, 2, 64), 1, 0.1), _rand((1, s, 2, 64), 2)
    _logits_above_60(q, k, v, (0, 0, 0), lambda j: (0, j, 0))
    qkv = torch.from_numpy(_pack(q, k, v, 1)).bfloat16()
    ours = attn.flash_attention_packed(qkv).float().numpy()
    clamped = np.asarray(flash_attention_packed(
        jnp.asarray(qkv.float().numpy(), jnp.bfloat16), 64, interpret=True)).astype(
            np.float32)
    np.testing.assert_allclose(ours[0, 0, :64], 1.0, atol=1e-2)
    assert np.abs(ours[0, 0, :64] - clamped[0, 0, :64]).min() > 0.5
    np.testing.assert_allclose(ours[0, 1:], clamped[0, 1:], atol=4e-2)
    np.testing.assert_allclose(ours[0, 0, 64:], clamped[0, 0, 64:], atol=4e-2)


def test_transposed_exact_softmax_differs_from_clamped_jax_kernel_above_60():
    """The same row in the transposed layout; the Pallas transposed kernel
    clamps on every dtype (attention.py:1305-1307)."""
    s = 512
    q, k, v = _rand((1, s, 1, 64), 3), _rand((1, s, 1, 64), 4, 0.1), _rand((1, s, 1, 64), 5)
    _logits_above_60(q, k, v, (0, 0, 0), lambda j: (0, j, 0))
    qkv_t = torch.from_numpy(_to_t(q, k, v)).bfloat16()
    ours = attn.flash_attention_transposed(qkv_t, 1).float().numpy()  # (64, 1, S)
    clamped = np.asarray(flash_attention_transposed(
        jnp.asarray(qkv_t.float().numpy(), jnp.bfloat16), 1, 64,
        interpret=True)).astype(np.float32)
    np.testing.assert_allclose(ours[:, 0, 0], 1.0, atol=1e-2)
    assert np.abs(ours[:, 0, 0] - clamped[:, 0, 0]).min() > 0.5
    np.testing.assert_allclose(ours[:, 0, 1:], clamped[:, 0, 1:], atol=4e-2)


# The switch sets of chip_smoke.py's phase 5, and the default.
SWITCH_SETS = {
    "default": {},
    "xf-off": {"GSWM_XF_ATTN": "0"},
    "packed": {"GSWM_XF_ATTN": "0", "GSWM_CRES_ATTN": "0", "GSWM_PACKED_ATTN": "1"},
    "transposed": {"GSWM_XF_ATTN": "0", "GSWM_CRES_ATTN": "0",
                   "GSWM_TRANSPOSED_ATTN": "1"},
    "seqhead": {"GSWM_FUSED_QKV_MODE": "seqhead"},
    "fused-qkv-off": {"GSWM_FUSED_QKV": "0"},
}
# sd-2-1's self-attention sites: (tokens at 512x512 | 768x768, channels,
# heads), head_dim 64
SD21_SITES = [(4096, 320, 5), (9216, 320, 5), (1024, 640, 10), (2304, 640, 10),
              (256, 1280, 20), (576, 1280, 20)]
# (switch set, tokens) -> (JAX route, port route) where the port drops a
# TPU memory gate (route_self_attention's docstring)
DIVERGENCES = {
    # cres_attention_fits: 9216 tokens do not fit
    ("xf-off", 9216): ("split", "cres"),
    # transposed_attention_fits: batch 2 and 4 are not multiples of 8
    ("transposed", 4096): ("split", "transposed"),
    ("transposed", 9216): ("split", "transposed"),
    # fused_qkv_attention_fits: 576 tokens at 1280 channels do not fit
    **{(name, 576): ("plain", "fused_qkv")
       for name in ("default", "xf-off", "packed", "transposed", "seqhead")},
}


def _jax_route(mod, x):
    """The JAX Attention's decision order (layers.py:388-535)."""
    for route in ("xf", "cres", "packed", "transposed", "fused_qkv"):
        if getattr(mod, f"_use_{route}")(x):
            return route
    return "split" if x.shape[1] >= mod._flash_min_seq() else "plain"


def _set_switches(monkeypatch, switches):
    for name in attn.ROUTE_SWITCHES:
        monkeypatch.delenv(name, raising=False)
    for name, value in switches.items():
        monkeypatch.setenv(name, value)


@pytest.mark.parametrize("name", list(SWITCH_SETS))
def test_route_matches_jax_predicates_on_sd21(name, monkeypatch):
    _set_switches(monkeypatch, SWITCH_SETS[name])
    seen = set()
    for batch in (2, 4):
        for s, c, h in SD21_SITES:
            mod = JAttention(heads=h, head_dim=64, dtype=jnp.bfloat16)
            want = _jax_route(mod, jax.ShapeDtypeStruct((batch, s, c), jnp.bfloat16))
            got = attn.route_self_attention(s, 64)
            expected = DIVERGENCES.get((name, s), (want, want))
            assert (want, got) == expected, (name, batch, s, c, h)
            seen.add(got)
    # each switch set reaches the tier it is for
    tier = {"xf-off": "cres", "packed": "packed", "transposed": "transposed",
            "fused-qkv-off": "split"}.get(name, "xf")
    assert tier in seen


# sd-1-4's self-attention sites at 512x512: (tokens, channels, heads), 8 heads
# of 40, 80 and 160; the mid block's 64 tokens stay plain on both sides
SD14_SITES = [(4096, 320, 8), (1024, 640, 8), (256, 1280, 8)]
# (switch set, batch, tokens) -> (JAX route, port route): the JAX transposed
# tier takes any head_dim % 8 == 0 at a batch of 8, the port's kernel 64 only
SD14_DIVERGENCES = {("transposed", 8, 4096): ("transposed", "split")}


@pytest.mark.parametrize("name", list(SWITCH_SETS))
def test_route_matches_jax_predicates_on_sd14(name, monkeypatch):
    """sd-1-4 at its batch 4 and 8 (guidance): level 0 takes xf (K2 at
    d = 40), levels 1 and 2 fused_qkv (K1 at 80 and 160) by default, as the
    JAX package's own predicates decide."""
    _set_switches(monkeypatch, SWITCH_SETS[name])
    for batch in (4, 8):
        for s, c, h in SD14_SITES:
            mod = JAttention(heads=h, head_dim=c // h, dtype=jnp.bfloat16)
            want = _jax_route(mod, jax.ShapeDtypeStruct((batch, s, c), jnp.bfloat16))
            got = attn.route_self_attention(s, c // h)
            assert (want, got) == SD14_DIVERGENCES.get((name, batch, s), (want, want)), \
                (name, batch, s, c, h)
    if name == "default":
        assert [attn.route_self_attention(s, c // h) for s, c, h in SD14_SITES] == \
            ["xf", "fused_qkv", "fused_qkv"]


def test_route_windows_follow_the_seq_switches(monkeypatch):
    _set_switches(monkeypatch, {"GSWM_XF_ATTN_MIN_SEQ": "5000",
                                "GSWM_FUSED_QKV_MAX_SEQ": "1000",
                                "GSWM_FLASH_MIN_SEQ": "600"})
    assert attn.route_self_attention(9216) == "xf"
    assert attn.route_self_attention(4096) == "cres"  # xf starts at 5000
    monkeypatch.setenv("GSWM_CRES_ATTN_MIN_SEQ", "5000")
    assert attn.route_self_attention(4096) == "split"
    assert attn.route_self_attention(1000) == "fused_qkv"
    assert attn.route_self_attention(1024) == "split"  # above fused-qkv's 1000
    assert attn.route_self_attention(599) == "fused_qkv"
    monkeypatch.setenv("GSWM_FUSED_QKV", "0")
    assert attn.route_self_attention(599) == "plain"
    assert attn.route_self_attention(600) == "split"
    monkeypatch.setenv("GSWM_PACKED_ATTN", "1")
    monkeypatch.setenv("GSWM_PACKED_ATTN_MIN_SEQ", "300")
    assert attn.route_self_attention(300) == "packed"
    assert attn.route_self_attention(300, head_dim=40) == "plain"  # packed needs 64


# (switch set, extra switches, batch, tokens, the tier both packages take)
LAYER_CASES = [
    ("default", {"GSWM_XF_ATTN_MIN_SEQ": "256"}, 2, 256, "xf"),
    ("xf-off", {"GSWM_CRES_ATTN_MIN_SEQ": "256"}, 2, 256, "cres"),
    ("packed", {"GSWM_PACKED_ATTN_MIN_SEQ": "256"}, 2, 256, "packed"),
    # the JAX transposed tier needs a batch of 8 (8-sublane DMA)
    ("transposed", {"GSWM_TRANSPOSED_ATTN_MIN_SEQ": "256"}, 8, 256, "transposed"),
    ("seqhead", {}, 2, 256, "fused_qkv"),
    # 512 keys: the blockwise Pallas flash kernel (fewer take its einsum)
    ("fused-qkv-off", {"GSWM_FLASH_MIN_SEQ": "256"}, 2, 512, "split"),
]


@pytest.mark.parametrize("name,extra,b,s,tier", LAYER_CASES,
                         ids=[case[0] for case in LAYER_CASES])
def test_attention_layer_matches_jax_under_switches(name, extra, b, s, tier,
                                                    monkeypatch):
    """fp32, 3 heads of 64 (an odd count: the packed pad head), 96 channels;
    atol 5e-5 and rtol 1e-4 (fp32 with different summation orders in the
    projections and the attention)."""
    _set_switches(monkeypatch, {**SWITCH_SETS[name], **extra})
    monkeypatch.setenv("GSWM_FORCE_FLASH", "1")
    flash_attention_fused_qkv._clear_cache()  # GSWM_FUSED_QKV_MODE: trace time
    h, c = 3, 96
    x = _rand((b, s, c), 30)
    jmod = JAttention(heads=h, head_dim=64, dtype=jnp.float32)
    params = jmod.init(jax.random.key(4), jnp.asarray(x))
    assert _jax_route(jmod.bind(params), jnp.asarray(x)) == tier
    try:
        want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    finally:
        flash_attention_fused_qkv._clear_cache()
    assert attn.route_self_attention(s, 64) == tier
    mod = Attention(c, c, h, 64)
    bridge.load_tree_(mod, params)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-5)


def test_new_wrappers_reject_other_devices_and_shapes():
    with pytest.raises(ValueError):
        attn.flash_attention_packed(torch.zeros((1, 8, 3 * 100)))  # not 3 * P * 128
    with pytest.raises(ValueError):
        attn.flash_attention_transposed(torch.zeros((190, 1, 8)), 1)  # not 3 * H * D
    with pytest.raises(ValueError):
        attn.flash_attention_packed(torch.empty((1, 8, 384), device="meta"))
    with pytest.raises(ValueError):
        attn.flash_attention_transposed(torch.empty((192, 1, 8), device="meta"), 1)
