"""The PyTorch port runs where jax is not installed: importing it (its tools
and ``chip_smoke.py`` included) and driving its tiny pipeline (prompt -> guided DPM++ generation -> VAE decode -> encode
-> inversion -> decode), its per-user-key path (multikey embed, both trace
searches) and its robustness bench (a short sweep, the Tree-Ring functions)
must load none of jax, flax, transformers, cryptography or safetensors; the
checkpoint loader and cache must import and load a tiny-xl checkpoint
directory with safetensors and transformers unimportable; and the bench must
import, and run all but its host attacks, where there is no PIL."""

import subprocess
import sys
import textwrap
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "transformers", "cryptography",
             "safetensors")


def test_port_imports_no_jax():
    code = textwrap.dedent(f"""
        import sys
        import torch
        torch.set_num_threads(1)
        import gswm_torch
        from gswm_torch import GSConfig, embed_latents, recover_message_bits
        from gswm_torch.models import bridge  # noqa: F401
        from gswm_torch.ops import attention, groupnorm  # noqa: F401
        from gswm_torch.pipelines import InversablePipeline
        from gswm_torch.schedulers import dpm  # noqa: F401
        from gswm_torch.core import multikey
        from gswm_torch.eval import registry, trace  # noqa: F401
        from gswm_torch.utils import io  # noqa: F401
        from gswm_torch.tools import paths, run_robustness_sweep  # noqa: F401
        from gswm_torch import distortions, treering
        from gswm_torch.cli import gs_distort  # noqa: F401
        from gswm_torch.eval import datasets, detection, report, sweep  # noqa: F401
        from gswm_torch.treering import compat  # noqa: F401
        from gswm_torch.tools import compare_kernels, profile_paths  # noqa: F401
        from gswm_torch.models.configs import PRESETS
        from gswm_torch.pipelines import inversable
        inversable._check_served_on_cuda(PRESETS["sd-1-4"], torch.bfloat16)
        assert [attention.kernel_head_dim(d) for d in (40, 80, 160)] == [64, 128, 192]
        import runpy
        runpy.run_path("chip_smoke.py", run_name="not_main")  # its imports alone
        cfg = GSConfig(key_hex="22" * 32, nonce_hex="33" * 16, message="x",
                       width=64, height=64, message_bits=32)
        zt, _ = embed_latents(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
        pipe = InversablePipeline("tiny", device="cpu", dtype=torch.float32)
        ids = torch.randint(0, 1000, (1, 77), generator=torch.Generator().manual_seed(1))
        images = pipe.generate(zt, prompt_ids=ids, num_steps=2, scheduler="DPMs")
        bits, _ = pipe.extract_bits(cfg, images=images, num_steps=2,
                                    scheduler="DPMs", refine=1)
        keys, nonces, msgs = [bytes([i]) * 32 for i in (1, 2)], [bytes(16)] * 2, [b"ab", b"cd"]
        mcfg = GSConfig(width=64, height=64, message_bits=16)
        lat, msg = multikey.embed_latents_multikey(
            mcfg, keys, nonces, msgs, generator=torch.Generator().manual_seed(2),
            device="cpu")
        records = [dict(key_hex=k.hex(), nonce_hex=n.hex(), message_hex=m.hex())
                   for k, n, m in zip(keys, nonces, msg)]
        assert trace.find_source(lat[1], records)[:2] == (1, 1.0)
        assert trace.find_source_device(lat[0], records, device="cpu")[:2] == (0, 1.0)
        rows = sweep.run_sweep(pipe, cfg, batch=1, num_steps=2, strengths=(0.5,),
                               attacks=("none", "compression", "elastic", "scaling"))
        assert [r.attack for r in rows] == ["none", "compression", "elastic", "scaling"]
        x = distortions.device_attacks.apply(images, "rotation", 30.0)
        mask = treering.get_watermarking_mask(zt.shape, device="cpu")
        pattern = treering.get_watermarking_pattern(zt.shape, device="cpu")
        marked = treering.inject_watermark(zt, mask, pattern)
        assert treering.get_p_value(marked, pattern, mask)[0] < 0.01
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in {FORBIDDEN!r})
        print("LOADED", loaded)
        assert not loaded, loaded
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


def test_bench_imports_and_runs_without_pil():
    """The machine with the card has no PIL: with it made unimportable the
    bench's modules import, the device sweep runs, and ``jpeg="host"`` (PIL's
    libjpeg) raises ImportError itself, with no fallback to the device JPEG."""
    code = textwrap.dedent("""
        import sys
        sys.modules["PIL"] = None
        import torch
        torch.set_num_threads(1)
        import gswm_torch.distortions, gswm_torch.eval.sweep, gswm_torch.treering
        import gswm_torch.treering.compat, gswm_torch.cli.gs_distort  # noqa: F401
        import gswm_torch.tools.run_robustness_sweep  # noqa: F401
        from gswm_torch import GSConfig
        from gswm_torch.distortions import relative_strength_to_absolute
        from gswm_torch.eval.sweep import run_sweep
        from gswm_torch.pipelines import InversablePipeline
        assert relative_strength_to_absolute(0.3, "compression") == 70
        cfg = GSConfig(key_hex="22" * 32, nonce_hex="33" * 16, message="x",
                       width=32, height=32, vae_scale=2, message_bits=32)
        pipe = InversablePipeline("tiny", device="cpu", dtype=torch.float32)
        kw = dict(batch=1, num_steps=2, attacks=("compression",), strengths=(0.5,))
        assert len(run_sweep(pipe, cfg, jpeg="device", **kw)) == 1
        try:
            run_sweep(pipe, cfg, jpeg="host", **kw)
        except ImportError as e:
            print("HOST JPEG RAISED", type(e).__name__)
        assert not any(m == "PIL" or m.startswith("PIL.") for m in sys.modules
                       if sys.modules[m] is not None)
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stdout + res.stderr
    assert "HOST JPEG RAISED" in res.stdout


def test_loader_and_cache_run_with_safetensors_and_transformers_blocked(tmp_path):
    """A tiny-xl checkpoint directory (written here with safetensors) loads
    through ``model_dir`` and goes through the cache in a process where
    safetensors and transformers cannot be imported; SDXL's tiny pipeline
    then generates from it."""
    import numpy as np
    import torch
    from safetensors.numpy import save_file

    from gswm_torch.pipelines import InversablePipeline

    pipe = InversablePipeline("tiny-xl", device="cpu", dtype=torch.float32)
    files = {"unet": ("unet", "diffusion_pytorch_model"),
             "vae": ("vae", "diffusion_pytorch_model"),
             "text": ("text_encoder", "model"), "text2": ("text_encoder_2", "model")}
    for part, (sub, name) in files.items():
        state = {k: v.float().numpy() for k, v in getattr(pipe, part).state_dict().items()}
        if part == "text2":
            state["text_projection.weight"] = np.eye(32, dtype=np.float32)
        (tmp_path / sub).mkdir()
        save_file(state, str(tmp_path / sub / f"{name}.safetensors"))
    code = textwrap.dedent(f"""
        import sys
        sys.modules["safetensors"] = None
        sys.modules["transformers"] = None
        import torch
        torch.set_num_threads(1)
        from gswm_torch.models import cache, loader
        from gswm_torch.pipelines import InversablePipeline
        pipe = InversablePipeline("tiny-xl", device="cpu", dtype=torch.float32,
                                  model_dir={str(tmp_path)!r})
        assert torch.equal(pipe.text2_projection, torch.eye(32))
        state = cache.load_or_convert({str(tmp_path / "cache")!r}, {str(tmp_path)!r},
                                      "unet", lambda: loader.load_unet_state({str(tmp_path)!r}))
        assert all(torch.equal(state[k], v.float()) for k, v in pipe.unet.state_dict().items())
        zt = torch.randn((1, 4, 8, 8), generator=torch.Generator().manual_seed(0))
        images = pipe.generate(zt, prompt_ids=torch.zeros((1, 77), dtype=torch.long),
                               num_steps=2)
        assert images.shape == (1, 3, 16, 16) and torch.isfinite(images).all()
        loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                        and m.split(".")[0] in {FORBIDDEN!r})
        print("LOADED", loaded)
        assert not loaded, loaded
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


def test_fit_tokenizer_and_clis_import_and_run_without_their_reference_deps(tmp_path):
    """The VAE fit, the CLIP BPE, the metrics, check_finite and the three
    CLIs (and chip_smoke.py, which drives them) load none of jax, the JAX
    package, transformers, PIL, regex or ftfy at import time; with PIL,
    regex and ftfy made unimportable the fit takes steps, the tokenizer
    encodes non-ASCII text and gs-embed-torch writes its records."""
    vocab = tmp_path / "vocab"
    vocab.mkdir()
    code = textwrap.dedent(f"""
        import json, sys
        for name in ("PIL", "regex", "ftfy"):
            sys.modules[name] = None
        import torch
        torch.set_num_threads(1)
        from gswm_torch.cli import gs_embed, gs_extract, gs_trace  # noqa: F401
        from gswm_torch.eval import metrics  # noqa: F401
        from gswm_torch.models import tokenizer
        from gswm_torch.tools import fit_vae
        from gswm_torch.utils import debug, fitting  # noqa: F401
        import runpy
        runpy.run_path("chip_smoke.py", run_name="not_main")
        loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                        and m.split(".")[0] in ("jax", "jaxlib", "flax", "gswm",
                                                "transformers", "PIL", "regex", "ftfy"))
        print("LOADED AT IMPORT", loaded)
        assert not loaded, loaded
        start = fit_vae.build_vae("tiny", "cpu").state_dict()
        state = fitting.fit_vae_roundtrip(fit_vae.build_vae("tiny", "cpu"), steps=2, batch=2)
        assert any(not torch.equal(state[k], start[k]) for k in state)
        chars = list(tokenizer.bytes_to_unicode().values())
        vocab = {{t: i for i, t in enumerate(chars + [c + "</w>" for c in chars]
                                             + ["<|startoftext|>", "<|endoftext|>"])}}
        open({str(vocab / "vocab.json")!r}, "w").write(json.dumps(vocab))
        open({str(vocab / "merges.txt")!r}, "w").write("#version: 0.2\\n")
        ids = tokenizer.load_tokenizer({str(vocab)!r})(["café 你好 x²"])
        assert ids.shape == (1, 77) and ids[0, 0] == vocab["<|startoftext|>"]
        gs_embed.main(["--key_hex", "22" * 32, "--seed", "1", "--width", "64",
                       "--height", "64", "--outdir", {str(tmp_path / "emb")!r},
                       "--device", "cpu"])
        loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                        and m.split(".")[0] in ("jax", "jaxlib", "flax", "gswm",
                                                "transformers", "PIL", "regex", "ftfy"))
        print("LOADED", loaded)
        assert not loaded, loaded
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout
    assert (tmp_path / "emb" / "info_data.jsonl").exists()


def test_host_surfaces_quality_and_memory_import_and_run_without_reference_deps(tmp_path):
    """The integrations and their shims, the CLIP score, the lossless
    artifact, profiling, the memory policy, the demo and the golden oracle
    import with jax, the JAX package, transformers, PIL, cryptography and
    safetensors unimportable; on the CPU the nodes embed, the score runs on a
    tiny CLIP directory the port writes itself, the artifact writes its
    rows and the profiler its trace."""
    code = textwrap.dedent(f"""
        import json, os, runpy, sys
        blocked = {FORBIDDEN!r} + ("gswm", "PIL")
        for name in blocked:
            sys.modules[name] = None
        import torch
        torch.set_num_threads(1)
        from gswm_torch.integrations import a1111, comfyui, comfyui_node  # noqa: F401
        from gswm_torch.eval import quality
        from gswm_torch.models import clip, loader, tokenizer
        from gswm_torch.utils import memory, profiling
        from gswm_torch.tools import memory_anchors, run_quality_artifact  # noqa: F401
        from gswm_torch.examples import roundtrip_demo  # noqa: F401
        from gswm_torch.compat import numpy_reference  # noqa: F401
        for name in ("GS_watermark_insert_for_webui.py",
                     "GS_watermark_insert_for_webui_v1.6.0_and_higher.py"):
            assert runpy.run_path("gswm_torch/integrations/scripts/" + name)["Script"] is None
        runpy.run_path("chip_smoke.py", run_name="not_main")
        os.chdir({str(tmp_path)!r})
        comfyui.GSLatent.device = "cpu"
        (latent, _) = comfyui.GSLatent().create_gs_latents(
            key="22" * 32, nonce="33" * 16, message="x", batch_size=2, use_seed=1,
            seed=1, width=64, height=64, message_length=32)
        assert latent["samples"].shape == (2, 4, 8, 8)
        assert a1111.gs_noise_batch("x", "44" * 32, device="cpu").shape == (4, 64, 64)
        cfg = {{"text_config": {{"vocab_size": 514, "hidden_size": 16,
                                "intermediate_size": 32, "num_hidden_layers": 1,
                                "num_attention_heads": 2, "eos_token_id": 513}},
               "vision_config": {{"hidden_size": 16, "intermediate_size": 32,
                                  "num_hidden_layers": 1, "num_attention_heads": 2,
                                  "image_size": 32, "patch_size": 8}},
               "projection_dim": 8}}
        from gswm_torch.tools import paths
        paths.CLIP_VIT_L14, paths.CLIP_PROCESSOR = cfg, dict(
            paths.CLIP_PROCESSOR, size={{"shortest_edge": 32}},
            crop_size={{"height": 32, "width": 32}})
        model = clip.build_clip(cfg, torch.Generator().manual_seed(0), device="cpu")
        directory = paths.write_clip_dir("clip", model)
        images = torch.rand((2, 3, 40, 48), generator=torch.Generator().manual_seed(1))
        scores = quality.measure_similarity(images, ["a cat", "a dog"], directory,
                                            device="cpu")
        assert scores.shape == (2,) and abs(scores).max() <= 1
        run_quality_artifact.main(["--preset", "tiny", "--res", "32", "--batch", "2",
                                   "--steps", "1", "--device", "cpu", "--out", "q.jsonl"])
        assert len(open("q.jsonl").read().splitlines()) == 5
        with profiling.trace("trace", device="cpu"), profiling.stage("s", device="cpu"):
            torch.ones(4) + 1
        assert os.path.exists("trace/trace.json") and "s" in profiling.stage_report()
        assert memory.suggest_batch(512, hbm_gb=80.0) > 8
        loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                        and m.split(".")[0] in blocked)
        print("LOADED", loaded)
        assert not loaded, loaded
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


def test_multi_device_set_imports_and_runs_without_jax():
    """The sharding package, ring attention, the host library and both
    multi-rank tools import with jax, the JAX package and the other
    reference dependencies unimportable; one gloo world-2 ring runs (its
    ranks load none of them either) and one find_source runs on the host
    library."""
    code = textwrap.dedent(f"""
        import sys
        blocked = {FORBIDDEN!r} + ("gswm",)
        for name in blocked:
            sys.modules[name] = None
        sys.path.insert(0, "tests")
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import gswm_torch.sharding, gswm_torch.sharding.launch  # noqa: F401
        from gswm_torch import hostlib
        from gswm_torch.ops import ring_attention
        from gswm_torch.tools import dryrun_multichip, run_config5_artifact  # noqa: F401
        from gswm_torch.eval import trace
        import _torch_dist_workers as workers
        if __name__ == "__main__":
            rng = np.random.default_rng(0)
            q, k, v = (rng.standard_normal((1, 128, 2, 16)).astype(np.float32)
                       for _ in range(3))
            ranks = gswm_torch.sharding.launch.spawn(workers.ring_loading, 2,
                                                     (q, k, v, blocked), "cpu")
            want = ring_attention.flash_attention_split(*map(torch.from_numpy, (q, k, v)))
            for r in ranks:
                assert r["calls"] == 1 and not r["loaded"], r
                assert np.abs(r["ring"] - want.numpy()).max() < 2e-5
            recs = [dict(key_hex=(bytes([i]) * 32).hex(), nonce_hex=bytes(16).hex(),
                         message_hex=bytes([i, i]).hex(), message_length=16) for i in (1, 2)]
            from gswm_torch.core.multikey import embed_latents_multikey
            from gswm_torch import GSConfig
            lat, _ = embed_latents_multikey(
                GSConfig(width=64, height=64, message_bits=16), [bytes([1]) * 32, bytes([2]) * 32],
                [bytes(16)] * 2, [bytes([1, 1]), bytes([2, 2])],
                generator=torch.Generator().manual_seed(2), device="cpu")
            assert trace.find_source(lat[1], recs)[:2] == (1, 1.0)
            assert hostlib.library().path.exists()
            loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                            and m.split(".")[0] in blocked)
            print("LOADED", loaded)
            assert not loaded, loaded
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout
