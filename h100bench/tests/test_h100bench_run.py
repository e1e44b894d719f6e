"""Whole runs on the CPU at the port's tiny presets, past the harness's look
for a card: the result's keys, and ``correct`` coming out false where the
timed path is broken underneath or the control takes the program's place.

The cells on one chip have no exchange between chips to leave out; the
faults they can have are planted here: a step that returns its state
unchanged, half of the batch left out, an answer altered where it is made.
"""

import pytest
import torch

from h100bench import cells, check, run

DATA = cells.HERE / "tests" / "data"
SEED = 2 ** 31 + 99
CELLS = ("tiny-extract", "tinyxl-generate")


def _run(name, traced=False, **kw):
    torch.set_num_threads(2)
    cell = cells.load(name, bench=DATA / "BENCHMARK.json", here=DATA)
    return run.run_cell(cell, SEED, 0.05, traced, "cpu", **kw)


@pytest.mark.parametrize("name", CELLS + ("tinyxl-extract",))
@pytest.mark.parametrize("traced", [False, True])
def test_result_line(name, traced):
    res = _run(name, traced)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    names = set(res["metrics"])
    if traced:
        assert {"busy_s", "window_s"} <= set(res["device"]) and "breakdown" in res
        assert names and all("." in n for n in names)
    else:
        assert "setup_s" in names and "peak_mem_gib" in names and len(names) == 3


def _step_unchanged(monkeypatch):
    from gswm_torch.pipelines import inversable

    monkeypatch.setattr(inversable, "ddim_step", lambda x, eps, a_from, a_to: x)


def _half_batch(monkeypatch):
    """The UNet computes the first half of its batch and hands it out twice."""
    from gswm_torch.models.unet import UNet2DCondition

    forward = UNet2DCondition.forward

    def half(self, latents, t, context, added=None):
        n = max(latents.shape[0] // 2, 1)
        part = None if added is None else {k: v[:n] for k, v in added.items()}
        out = forward(self, latents[:n], t, context[:n], part)
        return torch.cat([out] * (latents.shape[0] // n))[: latents.shape[0]]

    monkeypatch.setattr(UNet2DCondition, "forward", half)


def _answer_altered(monkeypatch):
    """Extraction: a voted bit flipped; generation: an embedded element's sign."""
    from gswm_torch.core import embed
    from gswm_torch.pipelines import inversable

    recover, to_latent = inversable.recover_message_bits, embed._bits_to_latent

    def flipped_bits(z, cfg):
        bits = recover(z, cfg).clone()
        bits[0, 0] ^= 1
        return bits

    def flipped_latent(*args):
        z = to_latent(*args).clone()
        z.view(-1)[7] *= -1
        return z

    monkeypatch.setattr(inversable, "recover_message_bits", flipped_bits)
    monkeypatch.setattr(embed, "_bits_to_latent", flipped_latent)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_step_unchanged, _half_batch, _answer_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(name)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The reference one precision below the configuration's in the
    program's place fails the cell's limits, and the program passes them."""
    res = _run(name, with_control=True)
    cell = cells.load(name, bench=DATA / "BENCHMARK.json", here=DATA)
    assert res["correct"] is True
    ok, checks = check.verdict(res["control"], cell.limits)
    assert ok is False, checks
