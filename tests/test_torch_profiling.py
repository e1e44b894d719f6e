"""The port's profiling hooks (``gswm_torch.utils.profiling``) beside the
JAX package's (``gswm.utils.profiling``): ``stage`` and ``stage_report`` as
tests/test_cache_profiling.py:57 tests them, ``device_stats`` refusing
without a card, ``trace`` writing a Chrome trace on the CPU."""

import json

import pytest
import torch

from gswm.utils import profiling as jprofiling
from gswm_torch.utils import profiling


def test_stage_timing():
    with profiling.stage("unit-test-stage", sync=False):
        pass
    rep = profiling.stage_report(reset=True)
    assert "unit-test-stage" in rep
    assert rep["unit-test-stage"]["count"] == 1


def test_stage_report_matches_the_references_shape():
    for name in ("a", "a", "b"):
        with profiling.stage(name, device="cpu"):
            pass
        with jprofiling.stage(name, sync=False):
            pass
    ours, theirs = profiling.stage_report(reset=True), jprofiling.stage_report(reset=True)
    assert ours.keys() == theirs.keys() == {"a", "b"}
    assert {k: (v["count"], sorted(v)) for k, v in ours.items()} == \
        {k: (v["count"], sorted(v)) for k, v in theirs.items()}
    assert profiling.stage_report() == {}


def test_stage_records_on_an_exception():
    with pytest.raises(ValueError):
        with profiling.stage("fails", device="cpu"):
            raise ValueError("inside")
    assert profiling.stage_report(reset=True)["fails"]["count"] == 1


def test_sync_on_the_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises((RuntimeError, AssertionError)):
        with profiling.stage("needs a card"):
            pass
    profiling.stage_report(reset=True)


def test_device_stats_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises((RuntimeError, AssertionError)):
        profiling.device_stats()


def test_trace_on_the_cpu_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace"), device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    data = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in data["traceEvents"]}
    assert any("mm" in str(n) for n in names)
    assert any("mm" in e.key for e in prof.key_averages())
