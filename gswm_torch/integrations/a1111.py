"""A1111 WebUI script shim — surface parity with both reference scripts
(scripts/GS_watermark_insert_for_webui_*.py); the port of
``gswm.integrations.a1111``.

Covers both WebUI generations:
  * <= 1.5.2: patch ``modules.processing.create_random_tensors`` around
    process_images (scripts/...lower.py:123-138);
  * >= 1.6.0: patch the class ``modules.rng.ImageRNG`` (scripts/...higher.py:
    175-190) — first() returns the watermark, next() falls back to normal
    noise.  The reference's finally-block bug (restoring the patched class
    instead of the original, scripts/...higher.py:189-190) stays fixed: both
    patches restore the real object.

Which generation runs, and whether this is a WebUI process at all, is read
from what can be imported (``importlib.util.find_spec``), not from an import
that fails.  Outside a WebUI process ``Script`` is None and
``gs_noise_batch`` is importable standalone: both patches delegate to it.
"""

from __future__ import annotations

import importlib.util

import torch

from gswm_torch.config import GSConfig, prepare_message_bytes
from gswm_torch.core.embed import embed_latents
from gswm_torch.eval.registry import KeyRegistry


def gs_noise_batch(
    message: str = "",
    key_hex: str = "",
    nonce_hex: str = "",
    seed: int = 42,
    use_random_seed: bool = False,
    use_repeat: bool = False,
    width: int = 512,
    height: int = 512,
    device="cuda",
    u=None,
) -> torch.Tensor:
    """One watermarked (4, H/8, W/8) float32 latent on ``device``,
    reference-script semantics: 32-byte payload (or 8-byte tiled x4 under
    use_repeat, scripts/...higher.py:31-47), x64 diffusion, the uniforms
    from a generator seeded with ``seed`` under use_random_seed, fresh
    entropy otherwise, or ``u`` (1, elements) when given."""
    cfg = GSConfig(
        key_hex=key_hex,
        nonce_hex=nonce_hex,
        message=message,
        message_bits=256,
        width=width,
        height=height,
        seed=int(seed) if use_random_seed else None,
        repeat4=use_repeat,
    ).resolved()
    msg = prepare_message_bytes(cfg.message, cfg.message_bytes_len, cfg.repeat4)
    lat, msg = embed_latents(cfg, batch=1, message_bytes=msg, u=u, device=device)
    key, nonce = cfg.resolve_key_nonce()
    KeyRegistry(".").record(key, nonce, msg, seed=seed if use_random_seed else None,
                            height=height, width=width)
    return lat[0]


def _importable(name: str) -> bool:
    """Whether ``name`` can be imported, its parent packages checked first
    (``find_spec`` of a dotted name imports the parent)."""
    parts = name.split(".")
    return all(importlib.util.find_spec(".".join(parts[:i + 1])) is not None
               for i in range(len(parts)))


def in_webui() -> bool:
    return _importable("gradio") and _importable("modules.scripts")


def _make_script():
    """Build the gradio Script class inside a WebUI process."""
    import gradio as gr

    import modules.scripts as scripts
    from modules import shared
    from modules.processing import process_images

    state = {}

    class GSWatermarkScript(scripts.Script):
        def title(self):
            return "GS watermark insert (gswm_torch)"

        def ui(self, is_img2img):
            message = gr.Textbox(label="Message (<=32 bytes; 8 with repeat)")
            key = gr.Textbox(label="Key_hex (64 hex chars)")
            nonce = gr.Textbox(label="Nonce_hex (32 hex chars, optional)")
            seed = gr.Number(label="randomSeed", value=42)
            use_random_seed = gr.Checkbox(label="Use random seed", value=False)
            use_repeat = gr.Checkbox(label="Use repeat (8-byte message x4)",
                                     value=False)
            return [message, key, nonce, seed, use_random_seed, use_repeat]

        def run(self, p, message, key, nonce, seed, use_random_seed, use_repeat):
            state.update(message=message, key=key, nonce=nonce, seed=seed,
                         use_random_seed=use_random_seed, use_repeat=use_repeat,
                         width=p.width, height=p.height)

            def gs_tensor():
                return gs_noise_batch(
                    state["message"], state["key"], state["nonce"],
                    state["seed"], state["use_random_seed"],
                    state["use_repeat"], state["width"], state["height"],
                    device=shared.device,
                )

            if _importable("modules.rng"):  # >= 1.6.0: class patch
                import modules.rng as rng_mod

                real_rng = rng_mod.ImageRNG

                class GSImageRNG(real_rng):
                    def __init__(self, shape, seeds, **kw):
                        super().__init__(shape, seeds, **kw)
                        self._gs_first = True

                    def first(self):
                        self._gs_first = False
                        return gs_tensor().unsqueeze(0)

                    def next(self):
                        if self._gs_first:
                            return self.first()
                        return super().next()

                rng_mod.ImageRNG = GSImageRNG
                try:
                    return process_images(p)
                finally:
                    rng_mod.ImageRNG = real_rng  # restore the REAL class

            # <= 1.5.2: function patch
            import modules.processing as processing

            real_creator = processing.create_random_tensors

            def advanced_creator(shape, seeds, *a, **kw):
                return gs_tensor().unsqueeze(0)

            processing.create_random_tensors = advanced_creator
            try:
                return process_images(p)
            finally:
                processing.create_random_tensors = real_creator

    return GSWatermarkScript


Script = _make_script() if in_webui() else None
