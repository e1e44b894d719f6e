"""The port's two multi-rank tools on gloo ranks of this CPU:
``gswm_torch.tools.dryrun_multichip`` at world 4 (all four legs: dp x tp
round trip > 0.97, DP decode bit-identical, ring at sp = 2 < 1e-4, UNet
under dp x sp < 1e-3, each asserted inside the tool) and
``gswm_torch.tools.run_config5_artifact`` at world 2 on a 64-record
registry (64 of 64 exact decodes, 16 of 16 attributions)."""

import json

from gswm_torch.tools import dryrun_multichip, run_config5_artifact


def test_dryrun_multichip_four_ranks():
    ranks = dryrun_multichip.main(["--spawn", "4", "--device", "cpu"])
    assert len(ranks) == 4
    for r in ranks:
        assert (r["world"], r["dp"], r["tp"], r["sp"]) == (4, 2, 2, 2)
        assert r["accuracy"] > dryrun_multichip.MIN_ROUNDTRIP
        assert r["dp_bits_differ"] == 0
        assert r["ring_err"] < dryrun_multichip.RING_BOUND
        assert r["unet_sp_err"] < dryrun_multichip.UNET_SP_BOUND
        assert r["unet_ring_calls"] == 3


def test_config5_artifact_two_ranks(tmp_path):
    out = tmp_path / "config5.jsonl"
    ranks = run_config5_artifact.main(["--n", "64", "--device", "cpu", "--spawn", "2",
                                       "--out", str(out)])
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["phase"] for r in rows] == ["embed_multikey", "decode_dp_sharded",
                                          "trace_native", "trace_device"]
    by = {r["phase"]: r for r in rows}
    assert by["decode_dp_sharded"]["exact_decodes"] == 64
    assert by["decode_dp_sharded"]["mesh_ranks"] == 2
    assert by["decode_dp_sharded"]["backend"] == "gloo"
    assert by["trace_native"]["correct_attributions"] == 16
    assert by["trace_device"]["correct"]
    assert ranks[0] == rows and len(ranks[1]) == 2  # rank 1 records phases 1 and 2
