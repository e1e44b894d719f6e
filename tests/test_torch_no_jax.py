"""The PyTorch port runs where jax is not installed: importing it and driving
its tiny pipeline (prompt -> guided DPM++ generation -> VAE decode -> encode
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
