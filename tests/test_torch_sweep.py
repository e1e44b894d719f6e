"""PyTorch port vs the JAX package: the robustness sweep, the detection
statistics, the reports and the prompt datasets.

The sweep runs on the tiny preset with one weight set in both packages (the
JAX pipeline's, through ``gswm_torch.models.bridge``), batch 2, 4 steps,
float32, on the CPU.  The port is fed the JAX package's draws (the embed's
uniforms, the texture field, each randomized attack's draws from the key the
reference folds for it), so every row sees the same images up to float32
rounding (atol 1e-4 over the pipeline, tests/test_torch_pipeline.py), and the
rows must be EQUAL: the same ``bit_accuracies`` image by image, the same
``tpr_at_1e6``.  The statistics and the report writers are host code and are
held exactly.
"""

import argparse
import dataclasses
import json
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gswm.config import GSConfig as JGSConfig
from gswm.eval import datasets as j_datasets
from gswm.eval import detection as j_detection
from gswm.eval import report as j_report
from gswm.eval import sweep as j_sweep
from gswm.pipelines import InversablePipeline as JPipeline
from gswm.treering import compat as j_compat
from gswm_torch.config import GSConfig
from gswm_torch.core.embed import embed_latents
from gswm_torch.eval import datasets, detection, report, sweep
from gswm_torch.eval.sweep import DEFAULT_ATTACKS, SweepResult, run_sweep
from gswm_torch.models.bridge import load_pipeline_params_
from gswm_torch.pipelines import InversablePipeline
from gswm_torch.tools import run_robustness_sweep
from gswm_torch.treering import compat
from gswm_torch.utils.io import load_jsonlines

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
BASE = dict(key_hex="22" * 32, nonce_hex="33" * 16, message="sweep", width=32,
            height=32, vae_scale=2, message_bits=32)
BATCH, STEPS = 2, 4
STRENGTHS = (0.3, 0.7)
TEXTURE = 0.05
RANDOMIZED = ("noise", "elastic", "erasing", "resizedcrop", "randomcrop")
ATTACKS = tuple(a for a in DEFAULT_ATTACKS if a != "reversed")
# relative 0.04 of (0, 100): a 4-step regeneration, the step count both
# packages have already run
REVERSED_STRENGTHS = (0.04,)


@pytest.fixture(scope="module")
def pipes():
    jpipe = JPipeline("tiny", dtype=jnp.float32)
    pipe = InversablePipeline("tiny", device="cpu", dtype=torch.float32)
    load_pipeline_params_(pipe, jpipe.unet_params, jpipe.vae_params,
                          jpipe.text_params)
    return jpipe, pipe


def jax_draws(rng, cfg, image_shape) -> dict:
    """What ``gswm.eval.sweep.run_sweep`` draws from ``rng`` (sweep.py:128-135,
    :169-170; gswm/core/embed.py:84; gswm/distortions/device.py), by the same
    jax calls, in this process (the reference's ``hash(attack)`` holds only
    within one)."""
    k_embed, k_attack, k_tex = jax.random.split(rng, 3)
    h, w = image_shape[-2:]
    draws = {
        "u": np.array(jax.random.uniform(k_embed, (BATCH, cfg.total_elements),
                                         dtype=jnp.float32)),
        "texture": np.array(jax.random.uniform(k_tex, image_shape, jnp.float32)),
    }
    for name in RANDOMIZED:
        key = jax.random.fold_in(k_attack, hash(name) % 2**31)
        if name == "noise":
            draws[name] = np.array(jax.random.normal(key, image_shape))
            continue
        ka, kb = jax.random.split(key)
        shape = (h, w) if name == "elastic" else ()
        draws[name] = (np.array(jax.random.uniform(ka, shape)),
                       np.array(jax.random.uniform(kb, shape)))
    return draws


@pytest.fixture(scope="module")
def sweeps(pipes, tmp_path_factory):
    """Both packages' rows: every attack but ``reversed`` at two strengths on
    textured images with a ``none@2step`` row, then ``reversed`` alone."""
    jpipe, pipe = pipes
    cfg, jcfg = GSConfig(**BASE), JGSConfig(**BASE)
    rng = jax.random.key(3)
    shape = (BATCH, 3, BASE["height"], BASE["width"])
    out = tmp_path_factory.mktemp("sweep") / "rows.jsonl"
    common = dict(batch=BATCH, num_steps=STEPS)
    main = dict(common, attacks=ATTACKS, strengths=STRENGTHS, texture_amp=TEXTURE,
                extract_steps_rows=(2,))
    regen = dict(common, attacks=("reversed",), strengths=REVERSED_STRENGTHS)
    want = j_sweep.run_sweep(jpipe, jcfg, rng=rng, **main) + \
        j_sweep.run_sweep(jpipe, jcfg, rng=rng, **regen)
    draws = jax_draws(rng, cfg, shape)
    got = run_sweep(pipe, cfg, draws=draws, out_jsonl=str(out), **main) + \
        run_sweep(pipe, cfg, draws=draws, **regen)
    return got, want, out


def test_sweep_row_order_is_the_reference(sweeps):
    got, want, _ = sweeps
    assert [(r.attack, r.relative_strength) for r in got] == \
        [(r.attack, r.relative_strength) for r in want]
    names = [r.attack for r in got]
    assert names[:2] == ["none@2step", "none"] and names.count("none") == 1
    assert names[2:4] == ["compression", "compression"] and names[-1] == "reversed"
    assert len(got) == 1 + 1 + 2 * (len(ATTACKS) - 1) + 1


@pytest.mark.parametrize("attack", ("none@2step",) + DEFAULT_ATTACKS)
def test_sweep_rows_equal_jax(sweeps, attack):
    got, want, _ = sweeps
    rows = [(g, w) for g, w in zip(got, want) if w.attack == attack]
    assert len(rows) == (1 if attack in ("none@2step", "none", "reversed") else 2)
    for g, w in rows:
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
        assert len(g.bit_accuracies) == BATCH
        assert all(0.0 <= a <= 1.0 for a in g.bit_accuracies)


def test_sweep_jsonl_has_the_reference_fields(sweeps):
    got, _, out = sweeps
    recs = load_jsonlines(str(out))
    assert len(recs) == len(got) - 1  # the main sweep's rows
    assert recs[1] == dataclasses.asdict(got[1])
    fields = [f.name for f in dataclasses.fields(j_sweep.SweepResult)]
    assert list(recs[0]) == fields == [f.name for f in dataclasses.fields(SweepResult)]
    committed = json.loads(
        (REPO / "benchmarks" / "robustness_sweep_sd21arch_tpu.jsonl").read_text()
        .splitlines()[0])
    assert set(committed) <= set(recs[0])


def test_sweep_from_a_generator_repeats(pipes):
    """Without fed draws the sweep draws from its generator: one seed gives
    the same rows twice, and the control row is the pipeline's extraction of
    the generated images."""
    _, pipe = pipes
    cfg = GSConfig(**BASE)
    kw = dict(batch=BATCH, num_steps=STEPS, attacks=("none", "noise", "erasing"),
              strengths=(0.5,))
    a = run_sweep(pipe, cfg, generator=torch.Generator().manual_seed(4), **kw)
    b = run_sweep(pipe, cfg, generator=torch.Generator().manual_seed(4), **kw)
    assert a == b and [r.attack for r in a] == ["none", "noise", "erasing"]
    zt, msg = embed_latents(cfg, generator=torch.Generator().manual_seed(4),
                            batch=BATCH, device="cpu")
    images = pipe.generate(zt, guidance_scale=1.0, num_steps=STEPS)
    bits, _ = pipe.extract_bits(cfg, images=images, num_steps=STEPS)
    want = np.unpackbits(np.frombuffer(msg, np.uint8))
    assert a[0].bit_accuracies == [float(np.mean(v == want)) for v in bits.numpy()]
    assert run_sweep(pipe, cfg, **kw) == \
        run_sweep(pipe, cfg, generator=torch.Generator().manual_seed(0), **kw)


def test_host_jpeg_equals_reference_and_rejects_other_modes(pipes):
    _, pipe = pipes
    x = np.random.default_rng(12).random((2, 3, 24, 24), dtype=np.float32)
    np.testing.assert_array_equal(sweep._host_jpeg(torch.from_numpy(x), 40),
                                  j_sweep._host_jpeg(x, 40))
    cfg = GSConfig(**BASE)
    rows = run_sweep(pipe, cfg, batch=BATCH, num_steps=STEPS, jpeg="host",
                     attacks=("compression",), strengths=(0.5,))
    assert rows[0].absolute_strength == 50.0 and len(rows[0].bit_accuracies) == BATCH
    with pytest.raises(ValueError, match="jpeg"):
        run_sweep(pipe, cfg, jpeg="gpu")


def test_add_texture_matches_jax():
    x = np.random.default_rng(13).random((2, 3, 20, 28), dtype=np.float32)
    key = jax.random.key(9)
    want = np.asarray(j_sweep._add_texture(jnp.asarray(x), 0.15, key))
    u = np.array(jax.random.uniform(key, x.shape, jnp.float32))
    got = sweep._add_texture(torch.from_numpy(x), 0.15, draws=u)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    g = torch.Generator().manual_seed(2)
    drawn = sweep._add_texture(torch.from_numpy(x), 0.15, generator=g)
    assert drawn.shape == got.shape and not torch.equal(drawn, got)


def test_sweep_tool_writes_rows_and_prints_the_table(tmp_path, capsys, monkeypatch):
    """With its defaults: the device JPEG (no PIL needed), the tiny VAE
    fitted first, and a file named after the preset under the git-ignored
    ``build/`` of the working directory."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    out = tmp_path / "build" / "robustness_sweep_tiny_torch.jsonl"
    results = run_robustness_sweep.main([
        "--device", "cpu", "--preset", "tiny", "--batch", "2", "--steps", "4",
        "--attacks", "none,compression,erasing"])
    printed = capsys.readouterr().out
    assert "running 3 attacks x 5 strengths" in printed
    # the tiny preset's VAE is fitted before its sweep, as the reference's is
    assert "fitting tiny VAE for image-roundtrip fidelity" in printed
    assert "WARNING" not in printed
    assert "| attack | s=0.1 | s=0.3 | s=0.5 | s=0.7 | s=0.9 |" in printed
    # five accuracies to three decimals (on the fitted VAE the mild
    # strengths may keep every bit: 1.000)
    assert re.search(r"^\| erasing \|( (?:0\.\d{3}|1\.000) \|){5}$", printed, re.M)
    recs = load_jsonlines(str(out))
    assert [r["attack"] for r in recs] == \
        ["none@50step", "none"] + ["compression"] * 5 + ["erasing"] * 5
    assert len(results) == len(recs) == 12


# -- compat's decoder helper, on the bridged pipelines ----------------------------


def test_latents_to_imgs_equals_reference(pipes):
    jpipe, pipe = pipes
    lat = np.random.default_rng(14).standard_normal((2, 4, 8, 8)).astype(np.float32)
    got = compat.latents_to_imgs(pipe, torch.from_numpy(lat))
    want = j_compat.latents_to_imgs(jpipe, jnp.asarray(lat))
    assert len(got) == 2 and got[0].size == (16, 16)
    for g, w in zip(got, want):
        assert isinstance(g, Image.Image)
        # uint8 pixels of float images that agree to 1e-5: one level apart
        # at most, where the value sits on a rounding edge
        diff = np.abs(np.asarray(g).astype(int) - np.asarray(w).astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01


# -- detection statistics ----------------------------------------------------------


@pytest.mark.parametrize("total_bits", [32, 64, 256, 1024])
def test_detection_statistics_equal_reference(total_bits):
    for fpr in (1e-2, 1e-6, 1e-9):
        assert detection.detection_threshold(total_bits, fpr) == \
            j_detection.detection_threshold(total_bits, fpr)
        for acc in np.linspace(0.4, 1.0, 25):
            assert detection.is_detected(acc, total_bits, fpr) == \
                j_detection.is_detected(acc, total_bits, fpr)
    for k in range(0, total_bits + 1, max(1, total_bits // 16)):
        assert detection.bit_match_pvalue(k, total_bits) == \
            j_detection.bit_match_pvalue(k, total_bits)
    accs = np.random.default_rng(total_bits).uniform(0.4, 1.0, 50)
    for fpr in (1e-3, 1e-6):
        assert detection.tpr_at_fpr(accs, total_bits, fpr) == \
            j_detection.tpr_at_fpr(accs, total_bits, fpr)
    assert detection.tpr_at_fpr([1.0, 0.5], total_bits) == 0.5
    assert detection.bit_match_pvalue(total_bits, total_bits) == 0.5 ** total_bits


# -- reports -----------------------------------------------------------------------


def _report_run(module, root: Path) -> str:
    sub = root / "sweep" / "jpeg_10"
    sub.mkdir(parents=True)
    args = argparse.Namespace(
        key_hex="aa", nonce_hex="bb", original_message_hex="cc",
        num_inference_steps=30, scheduler="DDIM")
    rep = module.BatchReport(str(sub), args)
    rep.record(str(sub / "img1.png"), 1.0, "101")
    rep.record(str(sub / "img2.png"), 0.9, "100")
    rep.record_error(str(sub / "img3.png"), ValueError("unreadable"))
    assert rep.close() == pytest.approx(0.95)
    rep2 = module.BatchReport(str(sub), args)
    assert rep2.already_done() == {"img1.png", "img2.png"}
    assert rep2.close() is None
    no_time = lambda text: re.sub(r"^Time,.*$", "Time,", text, flags=re.M)  # noqa: E731
    return "\n--\n".join(
        no_time(p.read_text().replace(str(root), "ROOT"))
        for p in (sub / "result.txt", root / "sweep" / "result.txt",
                  sub / "results.jsonl"))


def test_batch_report_equals_reference_but_for_the_time(tmp_path):
    got = _report_run(report, tmp_path / "t")
    want = _report_run(j_report, tmp_path / "j")
    assert got == want
    assert "img1.png, Bit Accuracy, 1.0" in got
    assert "Average Bit Accuracy, 0.95" in got
    assert "jpeg_10, Average Bit Accuracy, 0.95" in got


def test_batch_report_skips_a_torn_line_and_nothing_else(tmp_path):
    args = argparse.Namespace(key_hex="", nonce_hex="", original_message_hex="",
                              num_inference_steps=1, scheduler="DDIM")
    rep = report.BatchReport(str(tmp_path), args)
    rep.record("a.png", 1.0)
    with open(rep.jsonl_path, "a") as f:
        f.write('{"bit_accuracy": 0.5}\n')  # no image name
        f.write('{"image": "b.png", "bit_acc')  # torn by an interrupted run
    assert rep.already_done() == {"a.png"}
    rep.close()


# -- prompt datasets ---------------------------------------------------------------


def test_get_dataset_sources(tmp_path):
    assert datasets.BUILTIN_PROMPTS == j_datasets.BUILTIN_PROMPTS
    assert datasets.get_dataset() == datasets.BUILTIN_PROMPTS
    assert datasets.get_dataset(limit=3) == datasets.BUILTIN_PROMPTS[:3]
    p = tmp_path / "prompts.jsonl"
    p.write_text('{"Prompt": "a"}\n{"Prompt": "b"}\n')
    assert datasets.get_dataset(str(p)) == ["a", "b"]
    t = tmp_path / "prompts.txt"
    t.write_text("x\ny\n\n")
    assert datasets.get_dataset(str(t)) == ["x", "y"]
    j = tmp_path / "prompts.json"
    j.write_text('{"caption": ["c", "d"]}')
    assert datasets.get_dataset(str(j), prompt_key="caption") == ["c", "d"]
    for source in (str(p), str(t), str(j)):
        key = "caption" if source.endswith(".json") else "Prompt"
        assert datasets.get_dataset(source, key) == j_datasets.get_dataset(source, key)
    with pytest.raises(ValueError):
        datasets.get_dataset(str(tmp_path))
    with pytest.raises(ValueError):
        datasets.get_dataset("prompts.csv")
