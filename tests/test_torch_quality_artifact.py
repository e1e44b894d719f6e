"""The port's lossless artifact (``gswm_torch/tools/run_quality_artifact.py``)
against the reference tool (``tools/run_quality_artifact.py``): the KS and
high-frequency-energy statistics equal to the reference's functions (loaded
from their file), and the rows on the tiny preset on the CPU under the
reference's field names, in the reference's order."""

import importlib.util
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from gswm_torch.tools import run_quality_artifact as artifact

ROOT = Path(__file__).resolve().parents[1]


def _reference_tool():
    spec = importlib.util.spec_from_file_location(
        "reference_quality_artifact", ROOT / "tools" / "run_quality_artifact.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n,m,shift", [(500, 700, 0.0), (4096, 4096, 0.05), (64, 64, 1.0),
                                       (10, 3, 0.3)])
def test_ks_statistics_equal_the_references(n, m, shift):
    ref = _reference_tool()
    rng = np.random.default_rng(n + m)
    a, b = rng.normal(size=n), rng.normal(loc=shift, size=m)
    assert artifact.ks_two_sample(a, b) == ref.ks_two_sample(a, b)
    assert artifact.ks_normal(a) == ref.ks_normal(a)
    assert artifact.ks_normal(b) == ref.ks_normal(b)


def test_hf_energy_equals_the_references():
    ref = _reference_tool()
    imgs = np.random.default_rng(3).uniform(size=(3, 3, 17, 23)).astype(np.float32)
    np.testing.assert_array_equal(artifact.hf_energy(imgs), ref.hf_energy(imgs))


def _reference_rows(tmp_path, batch, steps):
    """The reference tool's jsonl on the tiny preset, its pipeline's generate
    replaced by seeded images (the rows' fields and the latent statistics
    are the tool's own; only the model is left out)."""
    out = tmp_path / "reference.jsonl"
    code = textwrap.dedent(f"""
        import runpy, sys
        import numpy as np
        import gswm.pipelines
        from gswm.models.configs import PRESETS

        class Pipeline:
            def __init__(self, preset, rng=None):
                self.preset = PRESETS[preset]
                self.calls = 0

            def generate(self, z, guidance_scale, num_steps):
                assert guidance_scale == 1.0 and num_steps == {steps}
                self.calls += 1
                b, _, h, w = np.asarray(z).shape
                rng = np.random.default_rng(self.calls)
                return rng.uniform(size=(b, 3, 2 * h, 2 * w)).astype(np.float32)

        gswm.pipelines.InversablePipeline = Pipeline
        sys.argv = ["run_quality_artifact.py", "--preset", "tiny", "--res", "64",
                    "--batch", "{batch}", "--steps", "{steps}", "--out", {str(out)!r}]
        runpy.run_path({str(ROOT / "tools" / "run_quality_artifact.py")!r},
                       run_name="__main__")
    """)
    env = {"JAX_PLATFORMS": "cpu", "GSWM_COMPILE_CACHE": str(tmp_path / "cache"),
           "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT, env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    return [json.loads(line) for line in out.read_text().splitlines()]


def test_rows_on_the_tiny_preset_carry_the_references_fields(tmp_path):
    batch, steps = 4, 2
    out = tmp_path / "port.jsonl"
    artifact.main(["--preset", "tiny", "--res", "64", "--batch", str(batch), "--steps",
                   str(steps), "--device", "cpu", "--out", str(out)])
    ours = [json.loads(line) for line in out.read_text().splitlines()]
    theirs = _reference_rows(tmp_path, batch, steps)
    assert len(ours) == len(theirs) == 5
    assert {"tool", "preset", "seed_protocol", "weights"} <= set(ours[0])
    for a, b in zip(ours[1:], theirs[1:]):
        assert list(a) == list(b)
        for key in a:
            if isinstance(b[key], dict):
                assert list(a[key]) == list(b[key])
        assert (a["space"], a["population"], a["batch"]) == (b["space"], b["population"], batch)
    latent = [r for r in ours if r.get("space") == "latent"]
    pixel = [r for r in ours if r.get("space") == "pixel"]
    assert [r["population"] for r in latent] == [r["population"] for r in pixel] == \
        ["wm_indep", "wm_fixed"]
    for r in latent:
        assert r["elements"] == batch * 4 * 32 * 32
        assert abs(r["wm_mean"]) < 0.05 and abs(r["wm_std"] - 1) < 0.05
        assert 0 <= r["ks2_p"] <= 1 and 0 <= r["ks1_normal_p"] <= 1
    for r in pixel:
        assert (r["res"], r["steps"]) == (64, steps)
        assert 0 <= r["wm_mean"] <= 1 and np.isfinite(r["psnr_population_means_db"])


def test_latent_seed_study_lands_in_the_meta_line(tmp_path, capsys):
    out = tmp_path / "rows.jsonl"
    artifact.main(["--preset", "tiny", "--res", "32", "--batch", "2", "--steps", "1",
                   "--device", "cpu", "--latent-seeds", "3", "--seed", "9", "--out", str(out)])
    meta = json.loads(out.read_text().splitlines()[0])
    assert [r["seed"] for r in meta["latent_seed_study"]] == [10, 11, 12]
    for r in meta["latent_seed_study"]:
        assert all(0 <= r[k] <= 1 for k in ("ks2_p", "ks1_normal_p", "plain_ks1_normal_p"))
    assert "latent ks2_p at 3 further seeds" in capsys.readouterr().out


def test_populations_come_from_independent_seeded_streams():
    """Same seed, same populations; wm_indep's images each under their own
    nonce, so no two rows share a quantized pattern; wm_fixed's one key and
    nonce give every row the same signs."""
    import torch

    from gswm_torch.pipelines import InversablePipeline

    pipe = InversablePipeline("tiny", device="cpu", dtype=torch.float32,
                              generator=torch.Generator().manual_seed(0))
    a = artifact.populations(pipe, 64, 3, seed=5)
    b = artifact.populations(pipe, 64, 3, seed=5)
    for x, y in zip(a, b):
        assert torch.equal(x, y) and tuple(x.shape) == (3, 4, 32, 32)
    indep, plain, fixed = a
    assert not torch.equal(indep[0] > 0, indep[1] > 0)
    assert torch.equal(fixed[0] > 0, fixed[1] > 0) and not torch.equal(fixed[0], fixed[1])
    assert not torch.equal(artifact.populations(pipe, 64, 3, seed=6)[1], plain)
