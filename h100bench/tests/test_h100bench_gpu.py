"""On the card (``-m gpu``; skipped elsewhere): a short run of each cell is
correct, and the control at the cell's own size is not.

    python3 -m pytest h100bench/tests -m gpu -q
"""

import json

import pytest

from h100bench import cells, check, run

SPEC = json.loads((cells.ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cells run on the card only")
    return "cuda:0"


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_cell_correct_and_control_not(card, name):
    cell = cells.load(name)
    res = run.run_cell(cell, 2 ** 32 + 3, 1.0, False, card, with_control=True)
    assert res["correct"] is True, res["checks"]
    ok, checks = check.verdict(res["control"], cell.limits)
    assert ok is False, checks
