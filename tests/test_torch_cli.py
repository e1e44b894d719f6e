"""PyTorch port vs the JAX package: the command-line tools gs-embed-torch,
gs-extract-torch and gs-trace-torch (``gswm_torch.cli``), the pipeline's
reference-name aliases, the metrics and ``check_finite``.

The tools run in this process with ``--device cpu``; the JAX package's run
beside them on the same flags.  Where a tool builds a pipeline, both get the
tiny preset with shared weights (the JAX package's, carried across by
``models.bridge``); images pass through PNG files, PIL included.  The
extracted bits, accuracies and attributions must be equal; the embed draws
differ by design (each package its own generator), so its records are
compared and its latents decoded.
"""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import gswm.pipelines
import gswm.utils.platform
from gswm.cli import gs_embed as j_embed_cli
from gswm.cli import gs_extract as j_extract
from gswm.cli import gs_trace as j_trace
from gswm.core.decode import decode_latents as j_decode_latents
from gswm.eval import metrics as jmetrics
from gswm.pipelines import InversablePipeline as JPipeline
from gswm.utils.debug import check_finite as j_check_finite
from gswm_torch.cli import gs_embed, gs_extract, gs_trace
from gswm_torch.config import GSConfig
from gswm_torch.core import bits as bitops
from gswm_torch.core.decode import recover_message_bits
from gswm_torch.core.embed import embed_latents
from gswm_torch.core.multikey import embed_latents_multikey
from gswm_torch.eval import metrics
from gswm_torch.eval.registry import KeyRegistry
from gswm_torch.models.bridge import load_pipeline_params_
from gswm_torch.pipelines import InversablePipeline
from gswm_torch.utils.debug import check_finite

torch.set_num_threads(2)
STEPS = 8


@pytest.fixture(scope="module")
def pipes():
    jpipe = JPipeline("tiny", dtype=jnp.float32)
    pipe = InversablePipeline("tiny", device="cpu", dtype=torch.float32)
    load_pipeline_params_(pipe, jpipe.unet_params, jpipe.vae_params, jpipe.text_params)
    return jpipe, pipe


@pytest.fixture
def quiet_jax(monkeypatch):
    """The JAX package's tools set its platform and compile cache first; in
    this process that stays the test run's own."""
    monkeypatch.setattr(gswm.utils.platform, "apply_platform_env", lambda: None)


def _without_time(text: str) -> list[str]:
    return [ln for ln in text.splitlines() if not ln.startswith("Time")]


def _save_png(image, path):
    arr = (np.asarray(image).transpose(1, 2, 0) * 255).round().astype(np.uint8)
    Image.fromarray(arr).save(path)


def test_cli_flags_default_to_the_card():
    assert gs_embed.build_parser().parse_args([]).device == "cuda"
    req = ["--key_hex", "aa", "--nonce_hex", "", "--original_message_hex", "bb"]
    args = gs_extract.build_parser().parse_args(req)
    assert args.device == "cuda"
    # the reference's defaults (PARITY.md:82-92), including its 1024s
    assert (args.width, args.height, args.message_length) == (1024, 1024, 1024)
    assert (args.num_inference_steps, args.batch, args.model_id) == (
        30, 8, "stabilityai/stable-diffusion-2-1-base")
    targs = gs_trace.build_parser().parse_args(["--registry", "r.jsonl"])
    assert (targs.device, targs.width, targs.message_length) == ("cuda", 512, 256)
    assert gs_extract.pipeline_dtype("cuda") == torch.bfloat16
    assert gs_extract.pipeline_dtype("cpu") == torch.float32


@pytest.mark.parametrize("flags", [
    ["--message", "cli-test", "--key_hex", "66" * 32, "--nonce_hex", "77" * 16,
     "--message_length", "256", "--seed", "5", "--width", "64", "--height", "64"],
    ["--message", "tiled", "--key_hex", "12" * 32, "--nonce_hex", "", "--use_repeat",
     "--seed", "9", "--n_samples", "2", "--width", "128", "--height", "96"],
])
def test_embed_writes_the_reference_records(tmp_path, quiet_jax, flags):
    """info_data.txt and the jsonl mirror equal the JAX tool's but for the
    time; the latents have the reference's shape and decode, under the JAX
    package's decoder, to the logged message bit for bit."""
    j_embed_cli.main(flags + ["--outdir", str(tmp_path / "jax")])
    gs_embed.main(flags + ["--outdir", str(tmp_path / "torch"), "--device", "cpu"])
    txt = {side: (tmp_path / side / "info_data.txt").read_text() for side in ("jax", "torch")}
    assert _without_time(txt["torch"]) == _without_time(txt["jax"])
    recs = {side: [json.loads(ln) for ln in
                   (tmp_path / side / "info_data.jsonl").read_text().splitlines()]
            for side in ("jax", "torch")}
    for rec in recs["jax"] + recs["torch"]:
        rec.pop("time")
    assert recs["torch"] == recs["jax"]
    lat = np.load(tmp_path / "torch" / "gs_latents.npy")
    assert lat.shape == np.load(tmp_path / "jax" / "gs_latents.npy").shape
    rec = recs["torch"][0]
    jcfg = j_extract.make_config(j_extract.build_parser().parse_args(
        ["--key_hex", rec["key_hex"], "--nonce_hex", rec["nonce_hex"],
         "--original_message_hex", rec["message_hex"], "--width", str(rec["width"]),
         "--height", str(rec["height"]), "--message_length", str(rec["message_length"])]))
    want = bitops.bits_to_bin_str(bitops.hex_to_bits(rec["message_hex"]))
    for row in lat:
        assert j_decode_latents(row, jcfg) == want[:rec["message_length"]]


def test_embed_generates_through_the_tokenizer(tmp_path, pipes, monkeypatch):
    """--model_dir and --prompt: the prompt goes through the port's own BPE
    (the ids CLIPTokenizer gives), the pipeline generates and the PNGs are
    written.  The checkpoint is stood in for by the tiny pipeline."""
    from transformers import CLIPTokenizer
    from transformers.models.clip.tokenization_clip import bytes_to_unicode

    _, pipe = pipes
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    chars = list(bytes_to_unicode().values())
    vocab = {t: i for i, t in enumerate(chars + [c + "</w>" for c in chars]
                                        + ["ca", "cat</w>", "<|startoftext|>",
                                           "<|endoftext|>"])}
    (model_dir / "vocab.json").write_text(json.dumps(vocab))
    (model_dir / "merges.txt").write_text("#version: 0.2\nc a\nca t</w>\n")
    seen = {}
    real_generate = pipe.generate

    def spy(latents, prompt_ids=None, **kw):
        seen["ids"] = prompt_ids
        return real_generate(latents, prompt_ids=prompt_ids, **kw)

    monkeypatch.setattr(pipe, "generate", spy)
    monkeypatch.setattr("gswm_torch.pipelines.InversablePipeline",
                        lambda preset, **kw: pipe)
    gs_embed.main(["--message", "m", "--key_hex", "21" * 32, "--seed", "3", "--width", "64",
                   "--height", "64", "--model_dir", str(model_dir), "--prompt", "a cat!",
                   "--n_samples", "2", "--num_inference_steps", "2", "--outdir",
                   str(tmp_path / "out"), "--device", "cpu"])
    want = CLIPTokenizer.from_pretrained(str(model_dir), local_files_only=True)(
        ["a cat!"] * 2, padding="max_length", max_length=77, truncation=True,
        return_tensors="np").input_ids
    np.testing.assert_array_equal(seen["ids"], want)
    assert sorted(p.name for p in (tmp_path / "out").glob("*.png")) == [
        "gs_00000.png", "gs_00001.png"]


def _extract_args(module, msg_hex, extra=()):
    return module.build_parser().parse_args(
        ["--key_hex", "88" * 32, "--nonce_hex", "99" * 16, "--original_message_hex",
         msg_hex, "--num_inference_steps", str(STEPS), "--width", "16", "--height", "16",
         "--message_length", "32", *extra])


def _tiny_config(module, args):
    # the tiny VAE's spatial factor is 2, not SD's 8
    return dataclasses.replace(module.make_config(args), vae_scale=2)


@pytest.fixture(scope="module")
def marked_pngs(pipes, tmp_path_factory):
    """Two PNGs of watermarked tiny images (16x16) and the message hex."""
    _, pipe = pipes
    cfg = GSConfig(key_hex="88" * 32, nonce_hex="99" * 16, message="cli",
                   width=16, height=16, vae_scale=2, message_bits=32)
    zt, msg = embed_latents(cfg, generator=torch.Generator().manual_seed(1), batch=2,
                            device="cpu")
    images = pipe.generate(zt, guidance_scale=1.0, num_steps=STEPS)
    d = tmp_path_factory.mktemp("marked")
    for i, im in enumerate(images.numpy()):
        _save_png(im, d / f"wm{i}.png")
    return d, msg.hex()


def test_extract_batch_equals_reference(pipes, marked_pngs):
    """extract_batch of both tools on one PNG, on shared weights: equal bits
    and accuracy; extract_arrays on the loaded array gives the same."""
    jpipe, pipe = pipes
    d, msg_hex = marked_pngs
    path = [str(d / "wm0.png")]
    jargs, args = _extract_args(j_extract, msg_hex), _extract_args(gs_extract, msg_hex)
    (_, jbits, jacc), = j_extract.extract_batch(jpipe, _tiny_config(j_extract, jargs),
                                                jargs, path)
    (_, bits, acc), = gs_extract.extract_batch(pipe, _tiny_config(gs_extract, args),
                                               args, path)
    assert (bits, acc) == (jbits, jacc)
    assert len(bits) == 32
    images = gs_extract.load_images(path, (16, 16))
    np.testing.assert_array_equal(images, j_extract.load_images(path, (16, 16)))
    assert gs_extract.extract_arrays(pipe, _tiny_config(gs_extract, args), args,
                                     torch.from_numpy(images)) == [(bits, acc)]


@pytest.mark.parametrize("mode", ["directory", "traverse", "resume", "single"])
def test_extract_main_modes_equal_reference(pipes, marked_pngs, tmp_path, monkeypatch,
                                            quiet_jax, capsys, mode):
    """tests/test_eval_cli_integrations.py:101-160 against the port's tool:
    a directory of two images (one inversion batch), subdirectories with
    the rolled-up result.txt, resume-by-skip, and one image.  Reports and
    printed accuracies equal the JAX tool's but for the time."""
    jpipe, pipe = pipes
    d, msg_hex = marked_pngs
    monkeypatch.setattr(gswm.pipelines, "InversablePipeline", lambda *a, **k: jpipe)
    monkeypatch.setattr(gs_extract, "make_pipeline", lambda args: pipe)
    for module in (j_extract, gs_extract):
        real = module.make_config
        monkeypatch.setattr(module, "make_config",
                            lambda args, real=real: dataclasses.replace(real(args),
                                                                        vae_scale=2))
    outputs = {}
    for side, module in (("jax", j_extract), ("torch", gs_extract)):
        root = tmp_path / side
        if mode == "traverse":
            for sub in ("jpeg_10", "jpeg_90"):
                shutil.copytree(d, root / sub)
        else:
            shutil.copytree(d, root)
        if mode == "resume":  # one image already done
            (root / "results.jsonl").write_text(json.dumps(
                {"image": "wm0.png", "bit_accuracy": 1.0, "extracted_bin": ""}) + "\n")
        flags = ["--batch", "2"]
        if mode == "single":
            flags += ["--single_image_path", str(root / "wm1.png")]
        else:
            flags += ["--images_directory_path", str(root)]
        if mode == "traverse":
            flags += ["--is_traverse_subdirectories", "1"]
        if mode == "resume":
            flags += ["--resume"]
        capsys.readouterr()
        module.main(["--key_hex", "88" * 32, "--nonce_hex", "99" * 16,
                     "--original_message_hex", msg_hex, "--num_inference_steps", str(STEPS),
                     "--width", "16", "--height", "16", "--message_length", "32", *flags])
        printed = capsys.readouterr().out
        reports = {str(p.relative_to(root)): p.read_text()
                   for p in sorted(root.rglob("result*"))}
        outputs[side] = (printed, reports)
    printed, reports = outputs["torch"]
    assert printed == outputs["jax"][0]
    assert "Bit Accuracy" in printed
    assert list(reports) == list(outputs["jax"][1])
    for name, text in reports.items():
        assert _without_time(text) == _without_time(outputs["jax"][1][name]), name
    if mode == "traverse":
        assert "jpeg_10, Average Bit Accuracy" in reports["result.txt"]
    if mode == "resume":
        assert "wm0.png" not in reports["result.txt"]


def test_extract_failing_chunk_ends_the_run(pipes, marked_pngs, tmp_path, monkeypatch):
    """A chunk that fails (here an unreadable PNG) raises out of the tool:
    nothing in the port swallows a failure.  The chunks before it are in the
    reports, which are closed with their average."""
    _, pipe = pipes
    d, msg_hex = marked_pngs
    shutil.copytree(d, tmp_path / "imgs")
    (tmp_path / "imgs" / "wm9.png").write_bytes(b"not a png")
    monkeypatch.setattr(gs_extract, "make_pipeline", lambda args: pipe)
    real = gs_extract.make_config
    monkeypatch.setattr(gs_extract, "make_config",
                        lambda args: dataclasses.replace(real(args), vae_scale=2))
    with pytest.raises(Exception, match="wm9.png"):
        gs_extract.main(["--key_hex", "88" * 32, "--nonce_hex", "99" * 16,
                         "--original_message_hex", msg_hex, "--num_inference_steps",
                         str(STEPS), "--width", "16", "--height", "16", "--message_length",
                         "32", "--batch", "1", "--images_directory_path",
                         str(tmp_path / "imgs"), "--device", "cpu"])
    done = [json.loads(x)["image"] for x in
            (tmp_path / "imgs" / "results.jsonl").read_text().splitlines()]
    assert done == ["wm0.png", "wm1.png"]
    assert "Average Bit Accuracy" in (tmp_path / "imgs" / "result.txt").read_text()


@pytest.fixture(scope="module")
def trace_case(pipes, tmp_path_factory):
    """tests/test_gs_trace_cli.py's case: three keys from a numpy seed, the
    latents embedded under each (16x16 geometry, 32-bit messages), their
    registry, and the tiny pipeline's images as PNGs."""
    jpipe, pipe = pipes
    rng = np.random.default_rng(0)
    keys = [rng.bytes(32) for _ in range(3)]
    nonces = [rng.bytes(16) for _ in range(3)]
    msgs = [rng.bytes(4) for _ in range(3)]
    cfg = GSConfig(width=16, height=16, vae_scale=2, message_bits=32)
    lat, msg_bytes = embed_latents_multikey(cfg, keys, nonces, msgs, device="cpu",
                                            generator=torch.Generator().manual_seed(1))
    root = tmp_path_factory.mktemp("trace")
    reg = KeyRegistry(str(root))
    for k, n, m in zip(keys, nonces, msg_bytes):
        reg.record(k, n, m, message_length=32)
    images = pipe.generate(lat, guidance_scale=1.0, num_steps=6)
    (root / "imgs").mkdir()
    for i, im in enumerate(images.numpy()):
        _save_png(im, root / "imgs" / f"u{i}.png")
    return root


@pytest.mark.parametrize("registry", ["jsonl", "mixed", "txt"])
def test_trace_attributions_equal_reference(pipes, trace_case, tmp_path, monkeypatch,
                                            quiet_jax, registry):
    """Both tools over the same PNGs and registry, on shared weights: the
    same best record and accuracy for every image.  ``jsonl``: one message
    length, the port scores on the device (find_source_device); ``mixed``: a
    fourth record of another length, the host loop; ``txt``: the reference's
    info_data.txt."""
    jpipe, pipe = pipes
    monkeypatch.setattr(gswm.pipelines, "InversablePipeline", lambda *a, **k: jpipe)
    monkeypatch.setattr(gs_extract, "make_pipeline", lambda args: pipe)
    reg = trace_case / "info_data.jsonl"
    if registry == "mixed":
        reg = tmp_path / "mixed.jsonl"
        reg.write_text((trace_case / "info_data.jsonl").read_text() + json.dumps(
            {"key_hex": "ab" * 32, "nonce_hex": "cd" * 16, "message_hex": "ef" * 8,
             "message_length": 64}) + "\n")
    elif registry == "txt":
        reg = trace_case / "info_data.txt"
    lines = {}
    for side, module, extra in (("jax", j_trace, []), ("torch", gs_trace,
                                                       ["--device", "cpu"])):
        out = tmp_path / f"{side}.jsonl"
        module.main(["--registry", str(reg), "--images_directory_path",
                     str(trace_case / "imgs"), "--model_id", "tiny",
                     "--num_inference_steps", "6", "--width", "16", "--height", "16",
                     "--message_length", "32", "--out_jsonl", str(out), *extra])
        lines[side] = [json.loads(x) for x in out.read_text().splitlines()]
    assert len(lines["torch"]) == 3
    assert lines["torch"] == lines["jax"]
    arrays = gs_extract.load_images(sorted(str(p) for p in (trace_case / "imgs").glob("*.png")),
                                    (16, 16))
    args = gs_trace.build_parser().parse_args(["--registry", str(reg), "--num_inference_steps",
                                               "6", "--message_length", "32"])
    got = gs_trace.attribute_arrays(pipe, gs_trace.load_registry(str(reg)), args, arrays)
    assert got == [(x["best_index"], x["accuracy"]) for x in lines["jax"]]


def test_aliases_equal_the_reference_aliases(pipes):
    jpipe, pipe = pipes
    g = torch.Generator().manual_seed(0)
    lat = pipe.get_random_latents(g, batch=2, height=16, width=24)
    jlat = jpipe.get_random_latents(jax.random.key(0), batch=2, height=16, width=24)
    assert lat.shape == jlat.shape and lat.dtype == torch.float32  # draws differ
    assert torch.equal(pipe.get_random_latents(), pipe.get_random_latents())
    ids = np.random.default_rng(1).integers(0, 1000, (2, 77))
    np.testing.assert_allclose(pipe.get_text_embedding(ids).numpy(),
                               np.asarray(jpipe.get_text_embedding(ids)),
                               rtol=1e-4, atol=1e-5)
    img = np.random.default_rng(2).random((2, 3, 16, 16), dtype=np.float32)
    mean = pipe.get_image_latents(img)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jpipe.get_image_latents(img)),
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(mean, pipe.image_to_latents(img))
    # sample=True: mean + exp(logvar / 2) x N(0, 1), scaled, from the generator
    sampled = pipe.get_image_latents(img, sample=True, generator=torch.Generator().manual_seed(3))
    m, logvar = pipe.vae.encode_moments(2.0 * torch.from_numpy(img) - 1.0)
    noise = torch.randn(m.shape, generator=torch.Generator().manual_seed(3))
    want = (m + torch.exp(0.5 * logvar) * noise) * pipe.preset.vae.scaling_factor
    torch.testing.assert_close(sampled, want)
    x = np.random.default_rng(4).standard_normal((1, 4, 8, 8)).astype(np.float32)
    for reverse in (False, True):
        got = pipe.backward_diffusion(torch.from_numpy(x), num_inference_steps=4,
                                      reverse_process=reverse)
        want = jpipe.backward_diffusion(jnp.asarray(x), num_inference_steps=4,
                                        reverse_process=reverse)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)
    out = pipe.generate_with_init(torch.from_numpy(x), guidance_scale=1.0, num_steps=2)
    assert torch.equal(out.init_latents, torch.from_numpy(x))
    np.testing.assert_allclose(pipe.decode_image(torch.from_numpy(x)).numpy(),
                               np.asarray(jpipe.decode_image(jnp.asarray(x))),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(InversablePipeline.torch_to_numpy(torch.ones(2)),
                                  JPipeline.torch_to_numpy(np.ones(2)))
    assert InversablePipeline.torch_to_numpy(torch.ones(2, dtype=torch.bfloat16)).dtype \
        == np.float32


def test_metrics_equal_reference():
    rng = np.random.default_rng(5)
    a, b = rng.integers(0, 2, 40), rng.integers(0, 2, (3, 32))
    assert metrics.bit_accuracy_bits(a, b[0]) == jmetrics.bit_accuracy_bits(a, b[0])
    for orig in (a[:32], b):
        np.testing.assert_array_equal(
            metrics.batched_bit_accuracy(orig, torch.from_numpy(b)).numpy(),
            np.asarray(jmetrics.batched_bit_accuracy(orig, b)))
    for h in ("0f3a", "abc", "0"):
        np.testing.assert_array_equal(metrics.message_hex_to_bits(h),
                                      jmetrics.message_hex_to_bits(h))
    assert metrics.calculate_bit_accuracy("f0", "11110001") == \
        jmetrics.calculate_bit_accuracy("f0", "11110001")


def test_check_finite_equals_reference():
    good = np.ones((2, 3), np.float32)
    bad = np.array([1.0, np.nan, np.inf, -2.0], np.float32)
    assert check_finite(torch.from_numpy(good)) and j_check_finite(good)
    with pytest.warns(RuntimeWarning, match="2 non-finite values"):
        assert not check_finite(torch.from_numpy(bad), name="z")
    with pytest.raises(FloatingPointError, match=r"z: 2 non-finite values \(50.00%\)"):
        check_finite(torch.from_numpy(bad), name="z", raise_on_bad=True)
    with pytest.raises(FloatingPointError) as want:
        j_check_finite(bad, name="z", raise_on_bad=True)
    with pytest.raises(FloatingPointError) as got:
        check_finite(bad.astype(np.float32), name="z", raise_on_bad=True)
    assert str(got.value) == str(want.value)


def test_recovered_message_of_cli_latents(tmp_path):
    """gs-embed-torch's latents, read back from gs_latents.npy, decode with
    the port's own decoder too."""
    gs_embed.main(["--message", "abc", "--key_hex", "31" * 32, "--nonce_hex", "41" * 16,
                   "--message_length", "64", "--seed", "1", "--width", "64", "--height",
                   "64", "--outdir", str(tmp_path), "--device", "cpu"])
    rec = json.loads((tmp_path / "info_data.jsonl").read_text())
    cfg = GSConfig(key_hex=rec["key_hex"], nonce_hex=rec["nonce_hex"], width=64, height=64,
                   message_bits=64)
    bits = recover_message_bits(torch.from_numpy(np.load(tmp_path / "gs_latents.npy")), cfg)
    np.testing.assert_array_equal(bits.numpy()[0], bitops.hex_to_bits(rec["message_hex"]))
