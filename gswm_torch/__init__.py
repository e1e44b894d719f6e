"""gswm_torch — Gaussian Shading watermarking in PyTorch, with hand-written
CUDA kernels for Hopper (H100).

The port of the JAX package ``gswm``, which stays beside it as the
reference.  This package imports torch, numpy and scipy, never jax.  It
covers watermarked generation (embed -> prompt-guided DDIM or DPM++ -> VAE
decode) and extraction (VAE encode -> inversion -> decode) for the SD 2.x
presets on the card in bfloat16, and for the SD 1.x presets on the CPU only
(their head dims of 40, 80 and 160 have no kernel yet: ``InversablePipeline``
refuses them on a CUDA device when it is built); per-user keys and
traceability (``core.multikey``, ``eval.trace``, ``eval.registry``); the
robustness bench (``distortions``, ``eval.sweep``) and the Tree-Ring toolkit
(``treering``).  On the layout of ``gswm``:

  core/        ChaCha20 keystream (CUDA kernels: one key, and a table of
               keys), bit diffusion, embed, decode, multikey
  eval/        bit accuracy, the key registry, the trace search, the
               robustness sweep, detection statistics, reports, prompt sets
  distortions/ the 15 batched attacks on the card (plain PyTorch) and the 16
               host attacks (PIL, imported when called)
  treering/    the FFT-ring watermark for comparison experiments
  cli/         gs_distort
  utils/       json and jsonl IO
  models/      UNet2DCondition, VAE encoder and decoder, CLIP text encoder,
               presets, the weight bridge from the JAX package's flax trees
  ops/         attention kernels (CUDA) and their plain versions
  schedulers/  DDIM and DPM++ plans and steps
  pipelines/   InversablePipeline
  csrc/        the CUDA sources; ``native`` builds them at first use
"""

__version__ = "0.1.0"

from gswm_torch.config import GSConfig  # noqa: F401
from gswm_torch.core.decode import decode_latents, recover_message_bits  # noqa: F401
from gswm_torch.core.embed import embed_latents  # noqa: F401
from gswm_torch.eval.metrics import calculate_bit_accuracy  # noqa: F401
