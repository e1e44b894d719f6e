"""The PyTorch port's mesh, batch sharding and tensor-parallel UNet
(``gswm_torch.sharding``) on gloo ranks of this CPU, against the JAX
package and against one process.

Two spawns, one of each world size (tests/_torch_dist_workers.py runs on the
ranks; each fixture runs once for the file): world 2 (mesh shapes, the
tp = 2 tiny UNet against ``gswm``'s UNet on the same weights, the sharded ops
and the DP round trip) and world 4 (dp x tp = 2 x 2 through the pipeline).
Bounds: the tp UNet within atol 1e-4 of the JAX UNet in fp32 (the row-parallel
sums add the ranks' partial products in another order); DP decode bit for
bit, its z_T within 1e-5 (batch 2 against batch 4 in the matmuls); the
sharded ops equal to their single-device calls.
"""

import jax
import numpy as np
import pytest
import torch

import _torch_dist_workers as workers
from gswm.models.configs import TINY
from gswm.models.unet import UNet2DCondition as JUNet
from gswm.sharding import unet_param_specs as j_unet_param_specs
from gswm_torch.models import bridge
from gswm_torch.sharding import make_mesh
from gswm_torch.sharding.launch import spawn

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny():
    """The JAX tiny UNet's params, the port's state dict of them, inputs."""
    jmod = JUNet(TINY.unet)
    params = jmod.init_params(jax.random.key(2))
    rng = np.random.default_rng(4)
    lat = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    t = np.array([10, 501], np.int32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    want = np.asarray(jax.jit(jmod.apply)(params, lat, t, ctx))
    state = {k: v.numpy() for k, v in bridge.convert_tree(params).items()}
    return dict(params=params, state=state, lat=lat, t=t, ctx=ctx, want=want)


@pytest.fixture(scope="module")
def world2(tiny):
    ranks = spawn(workers.sharding_world2, 2,
                  (tiny["state"], tiny["lat"], tiny["t"], tiny["ctx"]), "cpu")
    return ranks


@pytest.fixture(scope="module")
def world4():
    return spawn(workers.sharding_world4, 4, device_type="cpu")


def test_multi_device_entry_points_default_to_the_card():
    """As every entry point of the port: the card unless the caller names
    the CPU."""
    import inspect

    from gswm_torch.sharding.launch import run_world
    from gswm_torch.tools import dryrun_multichip, run_config5_artifact

    for fn in (make_mesh, spawn, run_world):
        assert inspect.signature(fn).parameters["device_type"].default == "cuda"
    for tool in (dryrun_multichip, run_config5_artifact):
        assert tool.build_parser().parse_args([]).device == "cuda"


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device_type="cpu")


def test_mesh_shapes_and_mismatch(world2):
    r = world2[0]
    assert r["mesh"] == {"dp": 2, "tp": 1}
    assert r["mesh_tp"] == {"dp": 1, "tp": 2}
    assert r["mesh_sp_names"] == ("dp", "tp", "sp")
    assert "dp*tp*sp=" in r["mismatch"] and "world size 2" in r["mismatch"]


def test_batch_sharding_and_replicate(world2):
    """dim 0 over dp, the rest replicated; ``replicate`` gives every rank
    rank 0's weights."""
    assert world2[0]["batch_sharding"] == ["Shard(dim=0)", "Replicate()"]
    assert not np.array_equal(world2[0]["own_weight"], world2[1]["own_weight"])
    for r in world2:
        np.testing.assert_array_equal(r["replicated_weight"], world2[0]["own_weight"])


def test_route_under_a_mesh_takes_split_or_plain(monkeypatch):
    """Under tp or sp > 1 (``sharded``) self-attention takes the split
    kernel from GSWM_FLASH_MIN_SEQ and plain attention below, whatever the
    other switches say (the JAX package's mesh gates, layers.py:251-380)."""
    from gswm_torch.ops.attention import route_self_attention

    monkeypatch.setenv("GSWM_PACKED_ATTN", "1")
    monkeypatch.setenv("GSWM_TRANSPOSED_ATTN", "1")
    assert route_self_attention(9216, 64) == "xf"
    assert route_self_attention(1024, 64) == "fused_qkv"
    assert route_self_attention(9216, 64, sharded=True) == "split"
    assert route_self_attention(1024, 64, sharded=True) == "split"
    assert route_self_attention(256, 64, sharded=True) == "plain"
    monkeypatch.setenv("GSWM_FLASH_MIN_SEQ", "64")
    assert route_self_attention(64, 16, sharded=True) == "split"


def test_param_specs_cover_attention_and_ff(world2, tiny):
    """attn1/attn2 q/k/v (Shard(0)) and to_out.0 (Shard(1)), GEGLU's proj
    (Shard(0), its bias too) and ff.net.2 (Shard(1)); at least 8 tp specs,
    as gswm's tests/test_sharding.py:75-83 asks of the JAX tree, and one for
    each of the JAX package's sharded kernels."""
    specs = world2[0]["specs"]
    sharded = {k: p for k, p in specs.items() if "Shard" in p}
    assert len(sharded) >= 8
    for name, p in sharded.items():
        col = name.endswith((".to_q.weight", ".to_k.weight", ".to_v.weight",
                             "ff.net.0.proj.weight", "ff.net.0.proj.bias"))
        assert p == ("Shard(dim=0)" if col else "Shard(dim=1)"), name
        assert ".attn1." in name or ".attn2." in name or ".ff." in name
    assert all(p == "Replicate()" for k, p in specs.items() if k not in sharded)
    flat = jax.tree_util.tree_leaves_with_path(
        j_unet_param_specs(tiny["params"]), is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
    j_tp = sum("tp" in str(s) for _, s in flat)
    assert j_tp == sum(k.endswith(".weight") for k in sharded)


def test_tp_slices_reassemble_into_the_weights(world2, tiny):
    """Each rank's slices concatenate into the whole weights: q/k/v rows and
    to_out.0 columns in rank order; GEGLU's proj rows as [h block r; gate
    block r] (rank 0 holds h and gate, not all of h), ff.net.2's columns the
    h blocks."""
    full = tiny["state"]
    a, b = world2[0]["slices"], world2[1]["slices"]
    assert world2[0]["tp_layers"] == world2[1]["tp_layers"] == 4 * 3
    for name, w in full.items():
        if name.endswith((".to_q.weight", ".to_k.weight", ".to_v.weight")):
            np.testing.assert_array_equal(np.concatenate([a[name], b[name]]), w)
            assert a[name].shape[0] == w.shape[0] // 2
        elif name.endswith(("to_out.0.weight", "ff.net.2.weight")):
            np.testing.assert_array_equal(np.concatenate([a[name], b[name]], axis=1), w)
        elif name.endswith(("ff.net.0.proj.weight", "ff.net.0.proj.bias")):
            half = w.shape[0] // 2
            h, gate = w[:half], w[half:]
            for r, part in enumerate((a[name], b[name])):
                blk = slice(r * half // 2, (r + 1) * half // 2)
                np.testing.assert_array_equal(part, np.concatenate([h[blk], gate[blk]]))
        else:
            np.testing.assert_array_equal(a[name], w)
            np.testing.assert_array_equal(b[name], w)


def test_tp_unet_matches_jax(world2, tiny):
    for r in world2:
        np.testing.assert_allclose(r["unet_tp"], tiny["want"], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(world2[0]["unet_tp"], world2[1]["unet_tp"])


def test_sharded_ops_equal_single_device(world2):
    """fused_group_norm_sharded over dp and flash_attention_sharded over tp
    equal their single-device calls; an odd batch and heads tp does not
    divide take the single-device call (groupnorm.py:165-171,
    attention.py:1522-1523)."""
    for r in world2:
        assert r["gn_equal"] and r["gn_odd_batch_equal"]
        assert r["flash_tp"][0], r["flash_tp"]
        assert r["flash_tp_odd_heads"][0]


def test_dp_decode_bit_identical(world2):
    for r in world2:
        assert r["dp_bits_equal"]
        assert r["dp_max_dz"] <= 1e-5


def test_dp_tp_pipeline_step(world4):
    """The counterpart of tests/test_sharding.py::test_dp_tp_pipeline_step."""
    for r in world4:
        assert r["mesh"] == {"dp": 2, "tp": 2}
        assert r["accuracy"] == 1.0
        assert r["tp_layers"] == 4 * 3

