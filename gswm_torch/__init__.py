"""gswm_torch — Gaussian Shading watermarking in PyTorch, with hand-written
CUDA kernels for Hopper (H100).

The port of the JAX package ``gswm``, which stays beside it as the
reference.  This package imports torch, numpy and scipy, never jax.  It
covers watermarked generation (embed -> prompt-guided DDIM or DPM++ -> VAE
decode) and extraction (VAE encode -> inversion -> decode) for the SD 1.x,
SD 2.x and SDXL presets on the card in bfloat16 (the attention kernels take
head dims d % 8 == 0 up to 512: SD 1.x's 40, 80 and 160, 64 elsewhere;
``InversablePipeline`` refuses other dtypes and head dims on a CUDA device
when it is built) and on the CPU in any dtype; per-user keys and
traceability (``core.multikey``, ``eval.trace``, ``eval.registry``); the
robustness bench (``distortions``, ``eval.sweep``) and the Tree-Ring toolkit
(``treering``).  On the layout of ``gswm``:

  core/        ChaCha20 keystream (CUDA kernels: one key, and a table of
               keys), bit diffusion, embed, decode, multikey
  eval/        bit accuracy, the key registry, the trace search, the
               robustness sweep, detection statistics, reports, prompt sets,
               the CLIP quality score
  distortions/ the 15 batched attacks on the card (plain PyTorch) and the 16
               host attacks (PIL, imported when called)
  treering/    the FFT-ring watermark for comparison experiments
  cli/         gs_embed, gs_extract, gs_trace, gs_distort
  integrations/ the ComfyUI node pair and the A1111 script, with the files
               their hosts load
  examples/    the roundtrip demo
  compat/      the golden NumPy oracle of the CPU tests
  utils/       json and jsonl IO, the VAE fit, check_finite, profiling
               hooks, the device-memory batch policy
  models/      UNet2DCondition, VAE encoder and decoder, CLIP text encoder
               and its BPE tokenizer, the CLIP towers of the quality score,
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
