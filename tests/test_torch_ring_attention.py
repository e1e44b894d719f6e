"""The PyTorch port's ring attention (``gswm_torch.ops.ring_attention``) on
gloo ranks of this CPU against ``gswm.ops.attention.reference_attention`` on
the same numpy inputs, with the reference's own bounds
(tests/test_ring_attention.py:30-103): fp32 atol 2e-5, bf16 atol 0.06.

Two spawns (tests/_torch_dist_workers.py on the ranks): world 2 (sp = 2,
fp32 and bf16, the fallbacks, the tiny UNet under sp) and world 4 (sp = 4
and dp x sp = 2 x 2).  The UNet under sp within 1e-3 of one process, as
the reference's dry run holds it.  Without spawns: the log-sum-exp plain
version and the ring's merge against one full attention.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_workers as workers
from gswm.ops.attention import reference_attention
from gswm_torch.ops import attention as attn
from gswm_torch.ops.ring_attention import ring_attention, ring_finish, ring_step
from gswm_torch.sharding.launch import spawn

torch.set_num_threads(2)


def _qkv(b=2, s=512, h=2, d=32, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32).astype(dtype)
            for _ in range(3)]


def _want(q, k, v):
    return np.asarray(reference_attention(*(jnp.asarray(a, jnp.float32) for a in (q, k, v))))


def _bf16(a):
    return torch.from_numpy(a).bfloat16()


CASES2 = {"sp2": (dict(dp=1, tp=1, sp=2), _qkv()),
          "sp2_short_shards": (dict(dp=1, tp=1, sp=2), _qkv(s=256, seed=1)),
          "no_mesh": (None, _qkv(s=256, seed=3)),
          "indivisible": (dict(dp=1, tp=1, sp=2), _qkv(s=301, seed=4))}
CASES4 = {"sp4": (dict(dp=1, tp=1, sp=4), _qkv(s=1024, seed=5)),
          "dp2_sp2": (dict(dp=2, tp=1, sp=2), _qkv(b=4, seed=6))}


@pytest.fixture(scope="module")
def world2():
    cases = [(name, dims, *qkv) for name, (dims, qkv) in CASES2.items()]
    q, k, v = _qkv(seed=7)
    cases.append(("sp2_bf16", dict(dp=1, tp=1, sp=2), *(_bf16(a) for a in (q, k, v))))
    return spawn(workers.ring, 2, (cases,), "cpu")


@pytest.fixture(scope="module")
def world4():
    return spawn(workers.ring, 4, ([(name, dims, *qkv) for name, (dims, qkv) in
                                    CASES4.items()],), "cpu")


@pytest.mark.parametrize("name", ["sp2", "sp2_short_shards"])
def test_ring_matches_reference_sp2(world2, name):
    """Shards of 256 keys (>= 512: the plain version; below: the einsum
    branch, each returning its lse); every rank holds the whole output."""
    want = _want(*CASES2[name][1])
    for r in world2:
        got, calls = r[name]
        assert calls == 1
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("name", ["sp4", "dp2_sp2"])
def test_ring_matches_reference_sp4_and_dp_sp(world4, name):
    want = _want(*CASES4[name][1])
    for r in world4:
        got, calls = r[name]
        assert calls == 1
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_ring_bf16(world2):
    q, k, v = _qkv(seed=7)
    want = _want(*(_bf16(a).float().numpy() for a in (q, k, v)))
    for r in world2:
        got, _ = r["sp2_bf16"]
        np.testing.assert_allclose(got, want, atol=0.06)


@pytest.mark.parametrize("name", ["no_mesh", "indivisible"])
def test_ring_falls_back(world2, name):
    """No mesh, and S = 301 that sp = 2 does not divide: the single-device
    call (ring_attention.py:105-114), no ring."""
    want = _want(*CASES2[name][1])
    for r in world2:
        got, calls = r[name]
        assert calls == 0
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("name,world,dims", [("sp2", 2, dict(dp=1, sp=2)),
                                             ("sp4", 4, dict(dp=1, sp=4)),
                                             ("dp2_sp2", 4, dict(dp=2, sp=2))])
def test_ring_matches_jax_ring_attention_in_fp32(world2, world4, name, world, dims):
    """The port's ring in fp32 on gloo ranks (its per-step kernel's plain
    version here: ``flash_attention_split(..., return_lse=True)``, whose
    fp32 kernel is csrc/flash_f32.cu's on the card) against the JAX
    package's ``ring_attention`` on a mesh of the same axes over the
    virtual CPU devices (as many as the ranks), on the same numpy inputs:
    fp32 atol 2e-5 (the reference's ring bound)."""
    import jax

    from gswm.ops.ring_attention import ring_attention as j_ring
    from gswm.sharding import make_mesh as j_make_mesh

    cases = CASES2 if world == 2 else CASES4
    q, k, v = cases[name][1]
    mesh = j_make_mesh(**dims, devices=jax.devices()[:dims["dp"] * dims["sp"]])
    with jax.sharding.set_mesh(mesh):
        want = np.asarray(jax.jit(j_ring)(*(jnp.asarray(a) for a in (q, k, v))))
    for r in (world2 if world == 2 else world4):
        got, calls = r[name]
        assert calls == 1 and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_unet_attention_reaches_the_ring_under_sp(world2, world4, world):
    """The tiny UNet's level-0 self-attention (64 tokens) takes the ring
    under an sp mesh (dp x sp at world 4) and the forward matches one
    process within 1e-3; 3 self-attention sites, one ring each."""
    for r in (world2 if world == 2 else world4):
        err, calls = r["unet_sp"]
        assert calls == 3
        assert err < 1e-3


@pytest.mark.parametrize("sk,chunks", [(1800, 3), (300, 3), (1024, 2)])
def test_lse_reference_and_merge_match_one_attention(sk, chunks):
    """``flash_attention_split_lse_reference``'s lse is the logsumexp of the
    logits, and the ring's fold of per-chunk (out, lse) over disjoint key
    sets is one attention over all keys (600-key chunks through the plain
    version, 100-key ones through the einsum branch)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(b=2, s=sk, h=3, d=32, seed=sk))
    q = q[:, :257].contiguous()
    out, lse = attn.flash_attention_split_lse_reference(q, k, v)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * 32**-0.5
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(logits, -1).numpy(),
                               atol=1e-5, rtol=1e-6)
    acc = None
    for kc, vc in zip(k.chunk(chunks, dim=1), v.chunk(chunks, dim=1)):
        acc = ring_step(q, kc.contiguous(), vc.contiguous(), acc)
    want = _want(q.numpy(), k.numpy(), v.numpy())
    np.testing.assert_allclose(ring_finish(acc, q.dtype).numpy(), want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out.numpy(), want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(acc[1].numpy(), lse.numpy(), atol=1e-5, rtol=1e-6)


def test_split_returns_lse_on_both_branches():
    """``return_lse`` on the plain version's branch and on the einsum branch
    below 512 keys: the output is the one without lse."""
    for s in (600, 100):
        q, k, v = (torch.from_numpy(a) for a in _qkv(b=1, s=s, h=2, d=16, seed=s))
        out, lse = attn.flash_attention_split(q, k, v, return_lse=True)
        assert torch.equal(out, attn.flash_attention_split(q, k, v))
        assert lse.shape == (1, 2, s) and lse.dtype == torch.float32


def test_ring_without_a_mesh_is_the_split_call():
    q, k, v = (torch.from_numpy(a) for a in _qkv(s=256, seed=9))
    assert torch.equal(ring_attention(q, k, v), attn.flash_attention_split(q, k, v))
    assert torch.equal(attn.flash_attention_sharded(q, k, v), attn.flash_attention_split(q, k, v))
