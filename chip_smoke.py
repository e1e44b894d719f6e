"""Drive the PyTorch port's paths once on one NVIDIA GPU (H100).

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure raises and exits nonzero:
  0. card     — refuse to run without CUDA; print the card's name and power
                limit (nvidia-smi).
  1. build    — compile gswm_torch/csrc/*.cu with nvcc (sm_90a), one nvcc
                process per source, all started together.
  2. kernels  — each kernel against its plain PyTorch version on the card at
                every shape the paths below give it, with the stated bounds;
                CUDA-event times of both, the least time the card could take
                (bound_ms, gswm_torch/roofline.py: FLOP over 989 TFLOP/s,
                attention's exponentials over 3.865e12/s, or bytes over 3.35
                TB/s; bound_by "operations" for either of the first two, the
                one that binds in "roof") and the time of one PyTorch call for
                the same function on the same tensors (library_ms: a
                yardstick the port never calls; the library's attention with
                its fused backends and, where those refuse the tensors, with
                its own choice, the backend printed; null where there is no
                such call or it refuses the shape).  Every path's shapes,
                SDXL's at 1024x1024 among them: K1 at 1024 tokens of 1280
                channels, K2 at 4096 tokens of 10 heads, K4 at 16,384
                tokens, K3 at 128 blocks; SD 1.x's at 512x512: K2 at 4096
                tokens of 8 heads of 40 (batch 4 and 8) and ragged (1, 1001,
                3, 40), beside it K2 at d = 8, 24 and 48 (flash_hopper.cu's
                narrow kernel) and 56 (its d <= 64 kernel), K1 at (4 and 8,
                1024, 640, 8 heads of 80) and (4 and
                8, 256, 1280, 8 of 160), K4 at (4, 1024, 8, 80), (1, 1000,
                2, 160) and a width no SD model uses, (2, 1000, 3, 72); K1,
                K2 and K4 are held to the bounds head by head, and their
                bounds count the true head dim.  K1's projection GEMM
                also alone,
                against x @ W^T in fp32.  The JSON line's ms, plain_ms,
                bound_ms and library_ms sum a kernel's shapes; its
                max_abs_err is their maximum.  K4 (csrc/flash_split.cu)
                also at D = 128 and 192 beside the VAE's 512.  K7 at the
                level-0 shapes at D = 64, at SD 1.x's (4 and 8, 4096, 8
                heads of 40) of switch set (c), at (4, 1024, 8, 80), (4,
                256, 8, 160), (2, 1000, 3, 72) and (1, 1024, 1, 512) (its
                split kernel), and at S % 8 != 0 shapes, which its masked
                kernel serves: (1, 1001, 3, 64), (1, 1001, 3, 40) and (1,
                1001, 2, 160); held head by head.  K8
                (fused GroupNorm) at every distinct (shape, eps, act) of the
                768x768 path's GroupNorms, collected by forward hooks during
                one UNet forward at batch 2 and at 4, one VAE decode of one
                image and one encode of two; one call under the profiler
                must be one kernel and allocate the output alone.  The batch
                ChaCha20 kernel (K3 over a key table) bit-exact against its
                plain version at (rows, blocks) = (4, 32), (4096, 32) and
                (10000, 32), against the single-key kernel row by row, one
                row's counter carrying into the high word; one
                batch_keystream_bits call must be one kernel.  (Both
                one-kernel checks stand at the head of the phase and read
                one profiler trace of 8 calls: 8 launch records on the
                host's side, and no kernel but the wrapper's on the
                device's.)  K1 at d = 80 also against F.linear + the
                library's attention in turns (5 rounds of library, kernel,
                kernel, library; medians and ranges), because the library's
                time there spreads with its host launches.
  3. extraction path, sd-2-1-base at 512x512, batch 4 (full batch; the time
     limit does not need a smaller one), random weights from a seed:
       (a) latent closed loop: embed -> 30-step DDIM generate -> 30-step
           inversion -> decode; voted bit accuracy >= 0.99 on every image;
       (b) the extraction chain (bench.py:173-177) on random images: embed +
           VAE encode + 30-step inversion + decode; finite, shaped, timed.
     K1 and K2 must launch exactly 10 and 5 times per UNet forward; K3
     exactly once on the whole path (the first embed: every later embed and
     decode takes the cached keystream); K4 must not (the VAE attention's
     4096 tokens keep the plain path).
     The memory sweep (gswm_torch/utils/memory.py; here, after phase 4 on the
     768x768 pipeline and after phase 9c on SDXL's): the extraction chain at
     batches 32, 64 and 128 (16, 32, 64 at 768x768; 8, 16, 32 at 1024x1024:
     at or above the VAE's chunk), 2 inversion steps, after one call at the
     smallest to warm up; each batch's peak device memory (the pipeline's
     weights and what the chain allocates, not the other pipelines resident)
     beside the model's prediction, within MEMORY_REL_BOUND; at 512x512 the
     peak at batch 32 with 30 steps beside 2, within 1%.  K1, K2 per
     forward, K3 once, K4 once a VAE encode chunk above 512x512.
  4. generation path, sd-2-1 (v-prediction) at 768x768, batch 2, random
     weights from a seed:
       (a) latent closed loop with DDIM at guidance 1.0, and (b) with DPM++:
           bit accuracy >= 0.99 on every image;
       (c) the watermark chain: embed -> seeded prompt ids -> 30-step DDIM at
           guidance 7.5 -> VAE decode -> VAE encode -> 30-step inversion ->
           decode; finite images in [0, 1], generation and extraction
           images/s (second pass).
     K4 must launch once per VAE chunk of (c): 2 decoder and 1 encoder
     launches at batch 2; K1 and K2 per forward as above; K3 exactly once.
  5. attention tiers, sd-2-1 at 768x768, batch 2: under each of the JAX
     package's switch sets in turn (the environment restored after each) —
       (a) GSWM_XF_ATTN=0: cres, K2 at level 0;
       (b) GSWM_XF_ATTN=0 GSWM_CRES_ATTN=0 GSWM_PACKED_ATTN=1: K6;
       (c) GSWM_XF_ATTN=0 GSWM_CRES_ATTN=0 GSWM_TRANSPOSED_ATTN=1: K7;
       (d) GSWM_FUSED_QKV_MODE=seqhead: K1, which serves the seqhead K5;
       (e) GSWM_FUSED_QKV=0: K4 at level 1, plain attention at level 2 —
     one UNet forward on the same latents, timestep and context as the
     default route, within TIER_REL_BOUND of it, with exact launch counts;
     its ms (CUDA events); and the latent closed loop (embed -> 10-step DDIM
     -> 10-step inversion -> decode; phases 3 and 4 hold the 30-step loops)
     at bit accuracy >= 0.99 on every image;
     K3 does not launch (phase 4 left the keystream of this key cached).
  6. GroupNorm op — K8 on the inputs of every GroupNorm of one UNet forward
     (batch 2), one decode and one encode at 768x768, each against the
     model's own GroupNorm output; one launch per GroupNorm.
  7. per-user keys at config-5 scale (gswm_torch/tools/paths.py): 10,000
     (key, nonce, message) records from a numpy seed, 512x512 geometry —
       (a) every record embedded under its own key (2,500 rows a call) and
           decoded back: 10,000 exact decodes; rows decoded under another
           row's key near 0.5;
       (b) find_source_device for 16 probes against the whole registry: 16
           correct attributions at accuracy 1.0, three batch launches a probe;
       (c) find_source (host loop) on a 256-record slice: the same accuracies
           as (b) on that slice, exactly;
       (d) per-user keys through the model: 4 images under 4 keys, sd-2-1-base
           at 512x512, embed -> 30-step generate -> 30-step inversion ->
           multikey decode >= 0.99 each, each recovered latent attributed to
           its own record among the 10,000.
     The batch kernel launches exactly once per batch_keystream_bits call.
  fit. the VAE fit: sd-2-1-base's VAE (sd-2-1 shares it) from a seed, in
     float32 master parameters; sign fidelity at 16x16 and 64x64 before; two
     of gswm_torch/tools/fit_vae.py's stages through fit_vae_roundtrip
     (GSWM_VAE_ATTN=chunked, GSWM_VAE_REMAT=block, bf16 autocast over fp32
     Adam): 16x16 latents, batch 32, lr 1e-3, 720 of the tool's 1500 steps
     (~120 s), then 64x64, batch 8, lr 1e-4, 90 of its 250 (~60 s), N of
     each printed (tools/paths.py FIT_STAGES; the 32 stage is left to the
     tool); steps/s and peak device memory a stage; no kernel launches
     across the fit (none has a backward); sign fidelity after at 16, 64
     and 96 (forward only in bf16, K4 twice at 96).  Limit: fidelity at
     64x64 >= 0.95 and above its value before.  The fitted state is then
     loaded into the 768x768 pipeline's VAE for phase 8.
  cli. the command-line path, sd-2-1-base at 512x512 on the fitted VAE:
     gs_embed.main four times into one directory (one --key_hex each,
     --n_samples 1, --seed, --message_length 256: four registry records);
     the four latents generated as one batch of 4 (30-step DDIM, guidance
     1.0, VAE decode) by the pipeline gs_extract.make_pipeline builds (the
     fitted state loaded into its VAE); for each key gs_extract's parser and
     make_config, then extract_arrays on that key's image (30 steps); then
     gs_trace's attribute_arrays on the four images against the registry
     gs_embed wrote.  PNG encode and decode are the one part of the CLI
     path the card does not run (no PIL there): the images pass as tensors.
     Limits: mean bit accuracy >= 0.99; every image attributed to its own
     record; K3 once a key (4, the caches cleared first; extraction takes
     the cached keystream); the batch kernel once a probe (4); K1 10 and K2
     5 launches a UNet forward.  Walls and images/s beside phase 3b's rate,
     extract_arrays's first key (the pipeline's first batch-1 inversion)
     apart from the other three.
  8. robustness bench, sd-2-1 at 768x768, batch 2 (gswm_torch/tools/paths.py),
     on the fitted VAE (its launch counts as before: the fit changes
     weights, not routes):
       (a) each of the 15 batched attacks (the DCT JPEG among them) at
           relative strength 0.5 on (2, 3, 768, 768) float32 images from a
           seed, and the cubic resize 768 -> 230 -> 768: the card's output
           against the same function on the CPU with the same draws (max
           |diff| <= 1e-4; flips, invert, erasing, randomcrop exact; the JPEG
           on all but 0.1% of the pixels, mean |diff| <= 1e-4); ms a call;
       (b) a short sweep: run_sweep over DEFAULT_ATTACKS at strength 0.5, 30
           steps, device JPEG: 17 rows in order, the ``none`` row equal to
           pipe.extract_bits on the same images, every accuracy finite in
           [0, 1], the jsonl written and read back, and exact launch counts
           from the rows: 30 forwards of generation, 17 rows of 30, and 50 +
           50 for ``reversed`` at 0.5: 640 forwards (K1 10 and K2 5 each), K4
           once a VAE encode of 2 images (17 rows and one inside
           ``reversed``) and twice a decode of 2 (generation, ``reversed``),
           K3 at most once, K6, K7, K8 never; every row printed beside the
           reference's at the same attack and strength
           (benchmarks/robustness_sweep_sd21arch_768_tpu.jsonl, accuracies
           only); the none row's mean bit accuracy >= 0.9; the images'
           mean pixel and share above 0.4 printed (where value attacks clip);
       (c) the Tree-Ring loop on latents: a ring pattern injected into 2
           latents, 30-step generate and invert beside 2 unmarked latents:
           the marked pair's FFT distance below the unmarked's, its p-value
           below 0.01 and below the unmarked's.
  9. SDXL, sdxl-base at 1024x1024, batch 2, bf16, random weights from a seed
     (built after phase 8, the 768x768 pipeline freed first), nothing cut:
       (a) latent closed loop: embed -> 30-step DDIM at guidance 1.0 ->
           30-step inversion -> decode; bit accuracy >= 0.99 on every image;
       (b) the watermark chain: embed -> seeded prompt ids through both text
           encoders -> 30-step DDIM at guidance 7.5 (UNet batch 4) -> VAE
           decode -> VAE encode -> 30-step inversion -> decode; finite images
           in [0, 1], generation and extraction images/s (second pass);
       (c) one UNet forward at batch 2 and at 4, ms (CUDA events).
     K1 60 and K2 10 launches per UNet forward (level 2 and the mid block at
     1024 tokens, depth 10; level 1 at 4096 tokens, depth 2; level 0 has no
     attention), K6, K7, K8 and K4 at D = 64 never; K4 once a VAE encode of 2
     images and twice a decode of 2; K3 exactly once (a new capacity, a new
     cache entry).  Then the memory sweep at 1024x1024 (above).
 10. SD 1.x, sd-1-4 at 512x512, batch 4, bf16, random weights from a seed
     (built after phase 9's pipeline is freed), nothing cut; 8 heads of 40,
     80 and 160:
       (a) latent closed loop: embed -> 30-step DDIM at guidance 1.0 ->
           30-step inversion -> decode; bit accuracy >= 0.99 on every image;
       (b) the watermark chain: embed -> seeded prompt ids through CLIP-L ->
           30-step DDIM at guidance 7.5 (UNet batch 8) -> VAE decode ->
           extract_bits (VAE encode, 30-step inversion, decode); finite
           images in [0, 1], generation and extraction images/s (second
           pass) beside sd-2-1-base's phase 3b rate;
       (c) one UNet forward under switch sets (a) cres (K2 at d = 40), (c)
           transposed (K7 at d = 40, 5 launches, the split kernel none: the
           reference's own route at the guided batch of 8) and (e)
           GSWM_FUSED_QKV=0 (the split kernel at d = 80 at level 1, plain at
           level 2), within TIER_REL_BOUND of the default route's; (c)'s
           difference from (a) printed beside;
       (d) one UNet forward at batch 4 and at 8, ms (CUDA events).
     Launches by head dim, exact: K1 5 at d = 80 and 5 at 160 a forward, K2
     5 at 40; K4 on the default route, K6, K7, K8 and the batch kernel
     never (K7 5 at d = 40 in (c)); K3 once after the keystream caches are
     cleared.
 11. the host surfaces and the lossless check, on sd-2-1-base at 512x512
     (run after phase 7, on its pipeline):
       (a) the lossless artifact (gswm_torch/tools/run_quality_artifact.py)
           at batch 8 a population, 30 steps, guidance 1.0: wm_indep's latent
           KS p-values (one-sample against N(0, 1), two-sample against the
           plain population) each >= 0.01; the pixel rows printed without a
           limit (random weights); K1 10 and K2 5 a forward, K3 once a (key,
           nonce, capacity): 9, the caches cleared first;
       (b) measure_similarity at openai/clip-vit-large-patch14's widths
           (tools/paths.py CLIP_VIT_L14; random weights from a seed, through
           a checkpoint directory written into build/) on (a)'s wm_indep
           images and 8 prompts: the card's scores within 1e-3 of the CPU's
           on the same weights and inputs (TF32 off); ms a call, device
           memory;
       (c) the integrations on the card: GSLatent (batch 4, use_seed 1 and
           0), gs_noise_batch (plain and use_repeat), the ComfyUI
           common_ksampler under stub comfy / latent_preview modules (the GS
           latent must be the noise handed to the sampler): every latent
           decoded at 1.0, then 30-step generate at guidance 1.0 and 30-step
           inversion at >= 0.99; K3 once a key (3); stage / stage_report /
           device_stats around it, a torch.profiler trace of the embeds into
           build/trace_phase11/.
  suggested batch (last, every other pipeline freed): sd-2-1-base's
     extraction chain at memory.suggest_batch(512) for this card, 2 steps,
     on a pipeline built anew: its peak under 90% of the card's memory,
     images/s printed.  The script runs under the allocator's expandable
     segments (PYTORCH_CUDA_ALLOC_CONF, set at its top), which the policy's
     batches need.  The seconds of this PR's phases are printed.
 12. multi-device on one card (the sharded functions, the tp UNet, the ring
     and the native host library; the card is one, so sharding is shown
     in every way one card allows):
       (a) K4 with its log-sum-exp output against its plain version at
           paths.LSE_SHAPES (sd-2-1 768x768 level 0, SDXL level 1, SD 1.x
           level 0 on the narrow kernel, (4, 1024, 8, 80), the SDXL VAE's
           mid attention at d = 512), each also as a query shard against a
           key shard of S / 4 (the wrapper's einsum branch below 512 keys):
           out within the attention bounds head by head, lse within 1e-2;
           ms, plain_ms, bound_ms and library_ms (aten's flash attention,
           which returns its logsumexp too; none above d = 256);
       (b) the ring on one card: ring_attention's per-rank step for every
           virtual rank of sp = 2 and 4 in ring order (the rotation an
           index), at (a)'s shapes, against one flash_attention_split call
           within the attention bounds; the ring's wall beside the call's;
           its K4-with-lse launches exact by head dim;
       (c) NCCL of world 1: flash_attention_sharded, ring_attention,
           fused_group_norm_sharded, shard_batch / gather_batch and a
           shard_params sd-2-1-base UNet forward (512x512, batch 2) equal to
           the single-device calls bit for bit; then
           tools.dryrun_multichip and tools.run_config5_artifact --n 10000
           (10,000 of 10,000 exact, 16 of 16 attributed) at world 1;
       (d) two ranks on the one card over gloo, asked for by name (NCCL
           refuses two ranks on one device), spawned by
           torch.multiprocessing: dp = 2 extraction of 4 watermarked latents
           of sd-2-1-base at 512x512, 30 + 30 steps, voted bits equal to
           the one-process run's (max |dz_T| printed; the gathers are given
           host tensors, moved here: gloo's all_gather is asked for on the
           host); then tp = 2: one UNet forward at 512x512, batch 2, bf16,
           level 0's 5 heads replicated, levels 1 and 2 sharded, within 2%
           of max |out| of the one-process forward on the same routes
           (split and plain), the default route's printed beside; K4
           launches by head dim on each rank;
       (e) the native host library (gswm_torch/hostlib) against its numpy
           plain versions and the card: quantize, keystream, decode and
           match count bit-exact over the 10,000-record registry (numpy on a
           slice of it), find_source's candidates/s on the library against
           the numpy loop, the build's seconds.
     The phase's seconds are printed.
 13. summary  — a JSON line of the kernels, then the JSON result line.
Each path's launch counts are set to 0 just before it and read just after.
"""

from __future__ import annotations

import os

# the memory policy's batches are sized on allocated bytes, which the default
# caching allocator fragments at those sizes (gswm_torch/utils/memory.py);
# set before torch touches the card
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import json
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from gswm_torch.tools import paths
from gswm_torch.tools.paths import (BATCH_768, KEY_HEX, NONCE_HEX, RES_768, STEPS)

BATCH, RES = paths.BATCH_512, paths.RES_512
# counter low word 2^32 - 5: the 64-bit block counter carries at block 5
CARRY_NONCE_HEX = (2**32 - 5).to_bytes(8, "little").hex() + "44" * 8

MIN_BIT_ACC = 0.99
# the fit phase: sign fidelity at 64x64 after it (the reference read 0.9928
# after its 16 stage and 0.9964 after its 64 stage, docs/BENCH.md:835-848)
MIN_FIDELITY_64 = 0.95
# phase 8 on the fitted VAE: the none row's mean bit accuracy (the
# reference's row reads 1.0)
MIN_FITTED_NONE = 0.9
# calls in the profiler window of a one-kernel check
ONE_KERNEL_CALLS = 8
# K1 at d = 80 against F.linear + the library's attention in turns: the
# order of a round, and the rounds
K1_TURNS = ("library", "kernel", "kernel", "library")
K1_TURN_ROUNDS = 5
# bf16 kernel vs fp32 plain version at unit-scale inputs: tightened from the
# 0.06 of tests/test_fused_qkv_attention.py:51-64; the kernels measured
# <= 0.006 at these shapes on an H100
ATTN_BOUND = 0.02
# and relative to the largest output entry: over thousands of keys a typical
# entry is ~0.02, so the absolute bound alone would pass an error of a few
# percent; bf16 rounding of p and of the output is ~0.4% of it
ATTN_REL_BOUND = 0.02
# K1's projection GEMM alone against x @ W^T in fp32, unit-scale x and
# C^-0.5-scale weights (outputs ~N(0, 1), below 8 in magnitude, where one
# bf16 rounding is at most 2^-6): absolute, and relative to max |want|
PROJ_BOUND = 0.02
PROJ_REL_BOUND = 0.01
# K8 against its fp32 plain version: bf16 rounding of outputs below 8 is at
# most 2^-6 / 2 = 0.0078 (GroupNorm outputs of unit-scale affine stay below
# ~6 at these sizes), and 1% of the largest output entry
GN_BOUND = 0.02
GN_REL_BOUND = 0.01
# a tier's UNet output against the default route's, relative to the largest
# entry: the routes compute one function in bf16 and differ by rounding at
# different points (projection GEMM shapes, padded to_out), which the
# 16 transformer blocks carry through; a wrong head or layout moves the
# output by O(1)
TIER_REL_BOUND = 0.05
# attention launches per UNet forward at 768x768 under each switch set of
# paths.TIER_SWITCHES; every other attention counter must stay 0
TIER_LAUNCHES = {
    "a": {"flash_attention": 5, "fused_qkv_attention": 10},
    "b": {"flash_attention_packed": 5, "fused_qkv_attention": 10},
    "c": {"flash_attention_transposed": 5, "fused_qkv_attention": 10},
    "d": {"flash_attention": 5, "fused_qkv_attention": 10},
    "e": {"flash_attention": 5, "flash_attention_split": 5},
}
ATTENTION_COUNTERS = ("fused_qkv_attention", "flash_attention", "flash_attention_split",
                      "flash_attention_packed", "flash_attention_transposed")
# K1 and K2 launches per SDXL UNet forward at 1024x1024: level 2 (2 down +
# 3 up transformers) and the mid block (1), depth 10, at 1024 tokens; level 1
# (2 down + 3 up), depth 2, at 4096 tokens
SDXL_K1 = (2 + 1 + 3) * 10
SDXL_K2 = (2 + 3) * 2
# K1 and K2 launches per sd-1-4 UNet forward at 512x512, by head dim: 8 heads
# of 80 at level 1 (1024 tokens) and of 160 at level 2 (256 tokens), of 40 at
# level 0 (4096 tokens), 2 down + 3 up transformers each; the mid block's 64
# tokens stay plain
SD14_PER_FORWARD = {"fused_qkv_attention": {80: 5, 160: 5}, "flash_attention": {40: 5}}
# the same under three switch sets of paths.TIER_SWITCHES: (a) cres, K2 at
# level 0; (c) transposed with xf and cres off: K7 at d = 40 at level 0, the
# split kernel never (the reference's route at its guided batch of 8, where
# its batch % 8 gate passes; the port drops that gate, so batch 4 too); (e)
# no fused qkv: the split kernel at d = 80 at level 1, plain attention at
# level 2
SD14_TIER_LAUNCHES = {
    "a": {"flash_attention": {40: 5}, "fused_qkv_attention": {80: 5, 160: 5}},
    "c": {"flash_attention_transposed": {40: 5}, "fused_qkv_attention": {80: 5, 160: 5}},
    "e": {"flash_attention": {40: 5}, "flash_attention_split": {80: 5}},
}
# the memory model (gswm_torch/utils/memory.py) against the measured peak at
# every swept batch, relative; the peak at 30 inversion steps against 2
MEMORY_REL_BOUND = 0.10
STEPS_PEAK_BOUND = 0.01
# CLIP's scores on the card against the CPU's, float32 with TF32 off: the
# two sum in different orders (~1e-6 relative a layer through 24 + 12
# layers), far below a score's scale of 1
CLIP_CARD_BOUND = 1e-3
CLIP_TIMED_CALLS = 5
# phase 11c's profiler trace
TRACE_DIR = os.path.join("build", "trace_phase11")
# phase 12: lse against its fp32 plain version, absolute, natural-log units
# (the kernels sum bf16-rounded p: ~1e-3 relative on the row sums)
LSE_BOUND = 1e-2
# phase 12d: the tp = 2 UNet forward against the one-process forward on the
# same routes, relative to max |out| (bf16 sums over tp in another order)
TP_REL_BOUND = 0.02
# phase 12e: the records the numpy plain versions are run on (numpy's
# decode takes milliseconds a record, its quantization tens)
HOST_PLAIN_SLICE = 256
# gswm/pipelines/inversable.py:330-348: VAE calls take vae_chunk images at
# 512x512, fewer in proportion to the pixels, and 8x fewer when decoding
VAE_CHUNK = 32


def phase_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's main path "
                         "runs only on the GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> None:
    from gswm_torch import native

    lib = native.library()
    ptxas = [ln.strip() for ln in lib.log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    for ln in ptxas:
        print(f"ptxas: {ln}")
    print(f"build: {lib.build_seconds:.2f} s -> {lib.path.name}", flush=True)


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _check_keystream(key: bytes, nonce: bytes, n_blocks: int) -> None:
    from gswm_torch.core import chacha

    got = chacha.keystream_words(key, nonce, n_blocks, "cuda")
    want = chacha.keystream_words_reference(key, nonce, n_blocks, "cuda")
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = (got != want).any(dim=1).nonzero()[:5].flatten().tolist()
        raise AssertionError(f"K3 keystream differs at {n_blocks} blocks, "
                             f"nonce {nonce.hex()}: blocks {bad}")


def _check_one_kernel(what: str, fn, kernel: str) -> None:
    """One call of ``fn`` launches one device kernel, ``kernel``.
    ONE_KERNEL_CALLS calls stand in one profiler window.  The count is read
    from the host's side of the trace, the launch records of the CUDA API
    (cudaLaunchKernel and its kin): exactly one a call.  The name is read from the device's side:
    every kernel record there is ``kernel`` (copies apart), and there is at
    least one.  The device's records alone cannot carry the count: the tracer
    maps the card's clock onto the host's, late in a process that mapping
    lags (its log warns "GPU op timestamp < runtime timestamp"), and it
    drops as out of range the records that then fall before the window's
    start: a lone kernel's always, a window's eight often
    (gswm_torch/tools/profile_paths.py counts both sides).  The
    host's launch records are stamped by the host's clock and are all there;
    phase 2 makes these checks at its head, while the process is young and
    the device's records are too."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.3)
        for _ in range(ONE_KERNEL_CALLS):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    events = prof.events()
    launches = [e.name for e in events
                if e.device_type.name == "CPU" and "launch" in e.name.lower()]
    kernels = [e.name for e in events if e.device_type.name == "CUDA"
               and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
    if len(launches) != ONE_KERNEL_CALLS:
        raise AssertionError(f"{what}: {ONE_KERNEL_CALLS} calls made {len(launches)} "
                             f"launches {sorted(set(launches))}, not one a call")
    if not kernels or len(kernels) > ONE_KERNEL_CALLS \
            or any(kernel not in name for name in kernels):
        raise AssertionError(f"{what}: {ONE_KERNEL_CALLS} calls ran {kernels}, not "
                             f"{kernel} alone")


def _check_batch_keystream(records: dict) -> None:
    """K3 over a key table: bit-exact against its plain version (all rows),
    against the single-key kernel (every row at 4 rows, 64 rows spread over
    the table beyond), against numpy's unpackbits of the host keystream (the
    bit order), with row 1's counter carrying at block 5; one kernel a call."""
    import numpy as np

    from gswm_torch import roofline
    from gswm_torch.core import chacha

    dev = "cuda"
    for rows, n_blocks in paths.K3_BATCH_SHAPES:
        n_bits = n_blocks * chacha.BLOCK_BITS
        keys, nonces, _, _ = paths.multikey_material(rows, seed=rows)
        nonces[1] = bytes.fromhex(CARRY_NONCE_HEX)
        got = chacha.batch_keystream_bits(keys, nonces, n_bits, dev)
        want = chacha.batch_keystream_bits_reference(keys, nonces, n_bits, dev)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = (got != want).any(dim=1).nonzero()[:5].flatten().tolist()
            raise AssertionError(f"K3 batch differs from its plain version at "
                                 f"{rows} rows: rows {bad}")
        del want
        for r in sorted({0, 1, *range(0, rows, max(1, rows // 64))}):
            if not torch.equal(got[r], chacha.keystream_bits(keys[r], nonces[r], n_bits, dev)):
                raise AssertionError(f"K3 batch row {r} of {rows} differs from the "
                                     "single-key kernel")
        host = np.unpackbits(np.frombuffer(
            chacha.keystream_bytes_host(keys[1], nonces[1], n_bits // 8), np.uint8))
        if not np.array_equal(got[1].cpu().numpy(), host):
            raise AssertionError("K3 batch: bit order differs from np.unpackbits")
        _check_one_kernel(
            f"batch_keystream_bits at {rows} rows",
            lambda: chacha.batch_keystream_bits(keys, nonces, n_bits, dev),
            "chacha20_batch_kernel")
        ms = _time_ms(lambda: chacha.batch_keystream_bits(keys, nonces, n_bits, dev), 10)
        plain = _time_ms(lambda: chacha.batch_keystream_bits_reference(
            keys, nonces, n_bits, dev), 2, warmup=1)
        bound = roofline.bound_ms(*roofline.chacha_batch_cost(rows, n_bits),
                                  roofline.PEAK_INT32)
        print(f"K3 chacha20 batch ({rows} rows x {n_blocks} blocks): bit-exact vs plain, "
              f"single-key kernel and unpackbits, one kernel a call; {ms:.4f} ms (plain "
              f"{plain:.4f}, bound {bound[0]:.6f} by {bound[1]}, library none)", flush=True)
        _record(records, "chacha20_batch", 0.0, ms, plain, bound, None)
        del got


def _check_group_norm_call(shape, act) -> None:
    """One K8 call: one kernel, and one allocation, its output (no scratch,
    no converted parameters)."""
    from gswm_torch.ops import groupnorm as gn

    x = torch.randn(shape, device="cuda").bfloat16()
    w, b = torch.ones(shape[1], device="cuda"), torch.zeros(shape[1], device="cuda")
    _check_one_kernel(f"fused_group_norm at {shape}",
                      lambda: gn.fused_group_norm(x, w, b, 32, 1e-5, act),
                      "gn_cluster_kernel")
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    out = gn.fused_group_norm(x, w, b, 32, 1e-5, act)
    made = torch.cuda.memory_stats()["allocation.all.allocated"] - before
    if made != 1:
        raise AssertionError(f"fused_group_norm at {shape} made {made} allocations")
    del out


def _library_ms(fn, iters: int, what: str = "library call"):
    """Time of the PyTorch call ``fn``; None, with its message and the
    reasons PyTorch warns of, if it refuses these tensors."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        try:
            return _time_ms(fn, iters)
        except RuntimeError as e:
            torch.cuda.synchronize()
            why = sorted({str(w.message).split(" (Triggered")[0] for w in seen})
            print(f"   {what} refused: {str(e).splitlines()[0][:120]} "
                  f"{' | '.join(why)[:400]}", flush=True)
            return None


def _sdpa_fused(q, k, v):
    """The library's attention on (B, H, S, D) views, held to its fused
    backends (one kernel a call)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                      SDPBackend.CUDNN_ATTENTION]):
        return F.scaled_dot_product_attention(q, k, v)


def _attention_library_ms(fn, iters: int):
    """(ms, backend) of the one PyTorch call that computes an attention
    case, ``fn(sdpa)``: with the fused backends first and, where they refuse
    the tensors (a head dim above 256, a last stride other than 1), with the
    call's own choice of backend, which then is the math path: still one
    call, but several kernels and an (Sq, Sk) logits array in device memory.
    (None, "none") only if that is refused too."""
    ms = _library_ms(lambda: fn(_sdpa_fused), iters, "library call, fused backends,")
    if ms is not None:
        return ms, "fused"
    ms = _library_ms(lambda: fn(F.scaled_dot_product_attention), iters,
                     "library call, any backend,")
    return ms, "none" if ms is None else "math"


def _heads_view(t, b, s, h, d):
    """(B, S, H*D) memory -> the (B, H, S, D) view."""
    return t.view(b, s, h, d).transpose(1, 2)


def _check_every_head(label: str, got, want) -> None:
    """(B, S, H, D) outputs: each head within ATTN_BOUND and ATTN_REL_BOUND
    of its own largest entry, so a head that a store past D overwrote, or
    whose tiles were read from the next head, shows however the others do."""
    err = (got - want).abs().amax(dim=(0, 1, 3))
    top = want.abs().amax(dim=(0, 1, 3))
    bad = ((err > ATTN_BOUND) | (err > ATTN_REL_BOUND * top)).nonzero().flatten().tolist()
    if bad:
        raise AssertionError(f"{label}: heads {bad} off their plain version: errors "
                             f"{err[bad].tolist()} against max|want| {top[bad].tolist()}")


def _record(records: dict, name: str, err: float, ms: float, plain: float,
            bound: tuple, library) -> None:
    rec = records.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                                        bound_ms=0.0, roof={}, library_ms=0.0))
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    rec["ms"] += ms
    rec["plain_ms"] += plain
    rec["bound_ms"] += bound[0]
    rec["roof"][bound[1]] = rec["roof"].get(bound[1], 0.0) + bound[0]
    # one refused shape leaves the kernel's sum without a yardstick
    rec["library_ms"] = None if library is None or rec["library_ms"] is None \
        else rec["library_ms"] + library


def _fmt(ms) -> str:
    return "none" if ms is None else f"{ms:.4f}"


def _time_in_turns(label: str, kernel, library) -> None:
    """``kernel`` and ``library`` timed in K1_TURNS order, K1_TURN_ROUNDS
    times: the library's time at SD 1.x's level 1 spreads with its host
    launches from one call to the next, so the two are read side by side."""
    t = {"library": [], "kernel": []}
    fns = {"library": library, "kernel": kernel}
    for _ in range(K1_TURN_ROUNDS):
        for side in K1_TURNS:
            t[side].append(_time_ms(fns[side], 20))
    med = {side: statistics.median(v) for side, v in t.items()}
    print(f"{label} in turns against F.linear + sdpa ({K1_TURN_ROUNDS} rounds of "
          f"{', '.join(K1_TURNS)}): kernel median {med['kernel']:.4f} ms "
          f"({min(t['kernel']):.4f}-{max(t['kernel']):.4f}), library median "
          f"{med['library']:.4f} ({min(t['library']):.4f}-{max(t['library']):.4f}), "
          f"library / kernel {med['library'] / med['kernel']:.2f}x", flush=True)


def phase_kernels(gn_cases) -> dict:
    """Each kernel vs its plain version; returns per-kernel records.
    ``gn_cases``: the (shape, eps, act) of K8's calls."""
    from gswm_torch import roofline
    from gswm_torch.core import chacha
    from gswm_torch.ops import attention as attn
    from gswm_torch.ops import groupnorm as gn

    dev = "cuda"
    records = {}
    key, nonce = bytes.fromhex(KEY_HEX), bytes.fromhex(NONCE_HEX)
    carry = bytes.fromhex(CARRY_NONCE_HEX)
    for shape, act in paths.K8_PROBE_CASES:
        _check_group_norm_call(shape, act)
    print(f"K8 group_norm: one kernel and one allocation a call at "
          f"{[c[0] for c in paths.K8_PROBE_CASES]}", flush=True)
    for n_blocks in paths.K3_BLOCKS:
        for nn in (nonce, carry):
            _check_keystream(key, nn, n_blocks)
        ms = _time_ms(lambda: chacha.keystream_words(key, nonce, n_blocks, dev), 50)
        plain = _time_ms(
            lambda: chacha.keystream_words_reference(key, nonce, n_blocks, dev), 5)
        bound = roofline.bound_ms(*roofline.chacha_cost(n_blocks), roofline.PEAK_INT32)
        print(f"K3 chacha20 ({n_blocks} blocks): bit-exact incl. counter carry; "
              f"{ms:.4f} ms (plain {plain:.4f}, bound {bound[0]:.6f} by {bound[1]}, "
              f"library none)", flush=True)
        _record(records, "chacha20", 0.0, ms, plain, bound, None)

    _check_batch_keystream(records)

    g = torch.Generator(device=dev).manual_seed(1234)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).bfloat16()

    # K1's projection GEMM alone, at K1's shapes below
    for b, s, c, h, d in paths.K1_SHAPES:
        x = rand(b, s, c)
        ws = [rand(h * d, c, scale=c**-0.5) for _ in range(3)]
        w_cat = torch.cat(ws)
        got = attn.qkv_projection(x, *ws)
        want = [x.float() @ w.float().t() for w in ws]
        err = max((a.float() - w).abs().max().item() for a, w in zip(got, want))
        top = max(w.abs().max().item() for w in want)
        ms = _time_ms(lambda: attn.qkv_projection(x, *ws), 20)
        bound = roofline.bound_ms(*roofline.projection_cost(b * s, c, h * d),
                                  roofline.PEAK_BF16)
        lib = _library_ms(lambda: F.linear(x, w_cat), 20)
        print(f"K1 projection GEMM (B={b}, S={s}, C={c}, H={h}, D={d}): max|err| {err:.5f} "
              f"(bound {PROJ_BOUND}), err/max|want| {err / top:.5f} (bound "
              f"{PROJ_REL_BOUND}); {ms:.4f} ms (bound {bound[0]:.4f} by {bound[1]}, "
              f"library {_fmt(lib)})", flush=True)
        if not (err <= PROJ_BOUND and err <= PROJ_REL_BOUND * top):
            raise AssertionError(f"K1 projection GEMM at {(b, s, c, h, d)}: error {err} "
                                 f"above {PROJ_BOUND} or {PROJ_REL_BOUND} x {top}")
        del got, want

    # (label, record, kernel, plain version, library call given the attention
    # function to use, (FLOP, bytes, exponentials), iterations, the output's
    # (B, S, H, D) view or None) at the shapes of gswm_torch/tools/paths.py.
    # Costs count the true head dim, not the panels the kernels pad it to
    cases = []
    for b, s, c, h, d in paths.K1_SHAPES:
        x = rand(b, s, c)
        ws = [rand(h * d, c, scale=c**-0.5) for _ in range(3)]
        w_cat = torch.cat(ws)

        def k1_library(sdpa, x=x, w_cat=w_cat, b=b, s=s, h=h, d=d):
            q, k, v = F.linear(x, w_cat).split(h * d, dim=-1)
            return sdpa(*(_heads_view(t, b, s, h, d) for t in (q, k, v)))

        cases.append((f"K1 fused_qkv (B={b}, S={s}, C={c}, H={h}, D={d})",
                      "fused_qkv_attention",
                      lambda x=x, ws=ws, h=h: attn.fused_qkv_attention(x, *ws, h),
                      lambda x=x, ws=ws, h=h: attn.fused_qkv_attention_reference(
                          x.float(), *(w.float() for w in ws), h),
                      k1_library, roofline.fused_qkv_cost(b, s, c, h, d), 20,
                      lambda t, b=b, s=s, h=h, d=d: t.view(b, s, h, d)))
    for b, s, h, d in paths.K2_SHAPES:
        q, k, v = (rand(b, s, h * d) for _ in range(3))
        cases.append((f"K2 flash (B={b}, S={s}, H={h}, D={d})", "flash_attention",
                      lambda q=q, k=k, v=v, h=h: attn.flash_attention(q, k, v, h),
                      lambda q=q, k=k, v=v, h=h: attn.flash_attention_reference(
                          q.float(), k.float(), v.float(), h),
                      lambda sdpa, q=q, k=k, v=v, b=b, s=s, h=h, d=d: sdpa(
                          *(_heads_view(t, b, s, h, d) for t in (q, k, v))),
                      roofline.attention_cost(b, s, s, h, d), 10,
                      lambda t, b=b, s=s, h=h, d=d: t.view(b, s, h, d)))
    # K4: the split wrapper runs csrc/flash_split.cu above D = 64 (512 in the
    # VAE; 128 and 192, an odd panel count, beside it; SD 1.x's 80 and 160
    # and 72 on padded panels) and csrc/flash_hopper.cu up to 64: a record
    # for each
    for b, s, h, d in paths.K4_SHAPES:
        q, k, v = (rand(b, s, h, d) for _ in range(3))
        cases.append((f"K4 flash_split (B={b}, S={s}, H={h}, D={d})",
                      "flash_attention_split_d64" if d <= 64 else "flash_attention_split",
                      lambda q=q, k=k, v=v: attn.flash_attention_split(q, k, v),
                      lambda q=q, k=k, v=v: attn.flash_attention_split_reference(
                          q.float(), k.float(), v.float()),
                      lambda sdpa, q=q, k=k, v=v: sdpa(
                          *(t.transpose(1, 2) for t in (q, k, v))),
                      roofline.attention_cost(b, s, s, h, d), 10, lambda t: t))
    # K6 and K7: UNet level 0 under their switches (5 heads: 3 pairs, the
    # last half a zero pad head).  The library call reads the kernel's own
    # layout through strided views (K6's with the pad head, K7's with a last
    # stride of B * S).  K6's bound counts the real heads alone: the pad
    # head's work is a loss of the layout, not work the UNet asks for
    for b, s, h in paths.LEVEL0_SHAPES:
        pairs = paths.pairs_of(h)
        qkv = rand(b, s, 3 * pairs * 128)
        for i in range(3):  # the pad head's projection rows are zero
            qkv[..., i * pairs * 128 + h * 64:(i + 1) * pairs * 128] = 0
        cases.append((f"K6 flash_packed (B={b}, S={s}, H={h}, P={pairs})",
                      "flash_attention_packed",
                      lambda qkv=qkv: attn.flash_attention_packed(qkv),
                      lambda qkv=qkv: attn.flash_attention_packed_reference(
                          qkv.float()),
                      lambda sdpa, qkv=qkv, pairs=pairs: sdpa(
                          *(t.unflatten(-1, (2 * pairs, 64)).transpose(1, 2)
                            for t in qkv.split(pairs * 128, dim=-1))),
                      roofline.attention_cost(b, s, s, h, 64), 10, None))
    # K7: S % 8 != 0 takes its masked kernel, the rest a wgmma + TMA one
    # (d > 64: the split one); every head on its own scale
    for b, s, h, d in paths.K7_SHAPES:
        qkv_t = rand(3 * h * d, b, s)
        cases.append((f"K7 flash_transposed (B={b}, S={s}, H={h}, D={d})",
                      "flash_attention_transposed",
                      lambda qkv_t=qkv_t, h=h: attn.flash_attention_transposed(qkv_t, h),
                      lambda qkv_t=qkv_t, h=h: attn.flash_attention_transposed_reference(
                          qkv_t.float(), h),
                      lambda sdpa, qkv_t=qkv_t, b=b, s=s, h=h, d=d: sdpa(
                          *qkv_t.view(3, h, d, b, s).permute(0, 3, 1, 4, 2)),
                      roofline.attention_cost(b, s, s, h, d), 10,
                      lambda t, b=b, s=s, h=h, d=d: t.view(h, d, b, s).permute(2, 3, 0, 1)))
    for label, name, kernel, plain_fn, library_fn, cost, iters, heads in cases:
        got = kernel().float()
        want = plain_fn()
        err = (got - want).abs().max().item()
        top = want.abs().max().item()
        if heads is not None:  # every head on its own scale
            _check_every_head(label, heads(got), heads(want))
        ms = _time_ms(kernel, iters)
        plain = _time_ms(plain_fn, 3)
        bound = roofline.attention_bound_ms(cost)
        lib, backend = _attention_library_ms(library_fn, iters)
        print(f"{label}: max|err| {err:.5f} (bound {ATTN_BOUND}), max|want| "
              f"{top:.5f}, err/max|want| {err / top:.5f} (bound {ATTN_REL_BOUND}); "
              f"{ms:.4f} ms (plain {plain:.4f}, bound {bound[0]:.4f} by {bound[1]}, "
              f"library {_fmt(lib)}, backend {backend})", flush=True)
        if not (err <= ATTN_BOUND and err <= ATTN_REL_BOUND * top):
            raise AssertionError(f"{label}: error {err} above {ATTN_BOUND} or "
                                 f"{ATTN_REL_BOUND} x {top}")
        _record(records, name, err, ms, plain, bound, lib)
        del got, want
    for label, _, kernel, _, library_fn, *_ in cases:
        if label.startswith("K1") and label.endswith("D=80)"):
            _time_in_turns(label, kernel, lambda fn=library_fn: fn(_sdpa_fused))
    # K8: unit-scale inputs with an offset, near-unit affine; the library
    # call is F.group_norm (+ F.silu) in bf16
    for shape, eps, act in gn_cases:
        x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).bfloat16()
        w = 1 + 0.05 * torch.randn(shape[1], generator=g, device=dev)
        bias = 0.05 * torch.randn(shape[1], generator=g, device=dev)
        got = gn.fused_group_norm(x, w, bias, 32, eps, act).float()
        want = gn.fused_group_norm_reference(x.float(), w, bias, 32, eps, act)
        err = (got - want).abs().max().item()
        top = want.abs().max().item()
        ms = _time_ms(lambda: gn.fused_group_norm(x, w, bias, 32, eps, act), 10)
        plain = _time_ms(lambda: gn.fused_group_norm_reference(x, w, bias, 32, eps, act), 3)
        bound = roofline.bound_ms(*roofline.group_norm_cost(shape), roofline.PEAK_FP32)
        wb, bb = w.bfloat16(), bias.bfloat16()

        def gn_library():
            y = F.group_norm(x, 32, wb, bb, eps)
            return F.silu(y) if act == "silu" else y

        lib = _library_ms(gn_library, 10)
        print(f"K8 group_norm {shape} eps {eps} act {act}: max|err| {err:.5f} (bound "
              f"{GN_BOUND}), err/max|want| {err / top:.5f} (bound {GN_REL_BOUND}); "
              f"{ms:.4f} ms (plain {plain:.4f}, bound {bound[0]:.4f} by {bound[1]}, "
              f"library {_fmt(lib)})", flush=True)
        if not (err <= GN_BOUND and err <= GN_REL_BOUND * top):
            raise AssertionError(f"K8 at {shape}: error {err} above {GN_BOUND} or "
                                 f"{GN_REL_BOUND} x {top}")
        _record(records, "fused_group_norm", err, ms, plain, bound, lib)
        del x, got, want
    print(f"K8 group_norm: 50-shape sums above: "
          f"{records['fused_group_norm']['ms']:.4f} ms against a bound of "
          f"{records['fused_group_norm']['bound_ms']:.4f} ms", flush=True)
    for rec in records.values():  # the roof behind most of the summed bound
        rec["roof"] = max(rec["roof"], key=rec["roof"].get)
        rec["bound_by"] = "bytes" if rec["roof"] == "bytes" else "operations"
    return records


def _wrappers() -> dict:
    from gswm_torch.core import chacha
    from gswm_torch.ops import attention as attn
    from gswm_torch.ops import groupnorm as gn

    return {"chacha20": chacha.keystream_words,
            "chacha20_batch": chacha.batch_keystream_bits,
            **{name: getattr(attn, name) for name in ATTENTION_COUNTERS},
            "fused_group_norm": gn.fused_group_norm}


def _counters() -> dict:
    """Each wrapper's launches; and, of the split wrapper's, those at
    D <= 64 (the record "flash_attention_split_d64"), which another kernel,
    csrc/flash_hopper.cu, runs; and its launches with the log-sum-exp
    output, by the same split ("flash_attention_split_lse_d64",
    "flash_attention_split_lse")."""
    counts = {name: fn.launches for name, fn in _wrappers().items()}
    split = _wrappers()["flash_attention_split"]
    counts["flash_attention_split_d64"] = sum(
        n for d, n in split.launches_by_d.items() if d <= 64)
    counts["flash_attention_split_lse_d64"] = sum(
        n for d, n in split.lse_launches_by_d.items() if d <= 64)
    counts["flash_attention_split_lse"] = sum(
        n for d, n in split.lse_launches_by_d.items() if d > 64)
    return counts


def _counters_by_d() -> dict:
    """The attention wrappers' launches by head dim."""
    return {name: dict(fn.launches_by_d) for name, fn in _wrappers().items()
            if name in ATTENTION_COUNTERS}


def _reset_counters() -> None:
    for name, fn in _wrappers().items():
        fn.launches = 0
        if name in ATTENTION_COUNTERS:
            fn.launches_by_d = {}
    split = _wrappers()["flash_attention_split"]
    split.lse_launches = 0
    split.lse_launches_by_d = {}


def _clear_keystream_caches() -> None:
    """A path that counts K3's launches starts with no keystream cached."""
    from gswm_torch.core import embed

    embed.clear_caches()


def _check_unet_launches(counts: dict, forwards: int, k1: int = 10, k2: int = 5) -> None:
    """Every UNet forward of SD 2.x at 512x512 and 768x768 has 5 level-1 + 5
    level-2 self-attention sites (K1) and 5 level-0 sites (K2); SDXL's at
    1024x1024 ``k1`` = 60 and ``k2`` = 10; with no switch set the packed and
    transposed tiers (K6, K7) never run."""
    if counts["fused_qkv_attention"] != k1 * forwards or \
            counts["flash_attention"] != k2 * forwards or \
            counts["flash_attention_packed"] or counts["flash_attention_transposed"]:
        raise AssertionError(f"unexpected attention launch counts {counts} "
                             f"for {forwards} UNet forwards")


def _bit_accuracy(bits, msg: bytes, dev) -> list:
    from gswm_torch.core import bits as bitops

    want = torch.from_numpy(bitops.bytes_to_bits(msg)).to(dev)
    return (bits == want).float().mean(dim=1).tolist()


def phase_extraction_512(card: str) -> dict:
    from gswm_torch import recover_message_bits

    dev = "cuda"
    t0 = time.perf_counter()
    pipe = paths.build_pipeline("sd-2-1-base")
    n_unet = sum(p.numel() for p in pipe.unet.parameters())
    torch.cuda.synchronize()
    print(f"pipeline: sd-2-1-base, UNet {n_unet / 1e6:.1f}M params, "
          f"built in {time.perf_counter() - t0:.2f} s", flush=True)
    cfg = paths.config(RES, "gswm_torch")

    _clear_keystream_caches()
    _reset_counters()
    # (a) latent closed loop
    zt, msg = paths.embed(cfg, BATCH, 5)
    c_embed = _counters()
    x0 = pipe.generate(zt, guidance_scale=1.0, num_steps=STEPS, decode=False)
    z_back = pipe.invert(latents=x0, num_steps=STEPS)
    bits = recover_message_bits(z_back, cfg)
    acc = _bit_accuracy(bits, msg, dev)
    sign = ((z_back > 0) == (zt > 0)).float().mean().item()
    print(f"(a) closed loop, batch {BATCH}, {STEPS}+{STEPS} steps: bit accuracy "
          f"{acc}, element sign agreement {sign:.4f}", flush=True)
    if min(acc) < MIN_BIT_ACC:
        raise AssertionError(f"closed-loop bit accuracy {acc} below {MIN_BIT_ACC}")
    if c_embed["chacha20"] != 1:
        raise AssertionError(f"K3 launched {c_embed['chacha20']} times in the first "
                             "embed under a new key, not once")

    # (b) the extraction chain on random images, once to warm up, once timed
    images = paths.random_images_512()
    walls = []
    for seed in (1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_bits, z_b, zt_b = paths.extraction_chain_512(pipe, cfg, images, seed)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    if tuple(out_bits.shape) != (BATCH, 256):
        raise AssertionError(f"bits shape {tuple(out_bits.shape)}")
    if not (torch.isfinite(z_b).all() and torch.isfinite(zt_b).all()):
        raise AssertionError("non-finite latents in the extraction chain")
    counts = _counters()
    print(f"(b) extraction chain, batch {BATCH}, {RES}x{RES}, {STEPS} steps: "
          f"wall {walls[1]:.4f} s ({BATCH / walls[1]:.4f} images/s; first pass "
          f"{walls[0]:.4f} s) on {card}", flush=True)
    print(f"launches on the 512x512 extraction path: {counts}", flush=True)
    for name in ("chacha20", "fused_qkv_attention", "flash_attention"):
        if counts[name] < 1:
            raise AssertionError(f"kernel {name} never launched on the 512 path")
    # one keystream for three embeds and three decodes under one key
    if counts["chacha20"] != 1:
        raise AssertionError(f"K3 launched {counts['chacha20']} times on the 512 path; "
                             "the cached keystream makes it 1")
    if counts["flash_attention_split"]:
        raise AssertionError("K4 launched at 512x512, where the VAE attention "
                             "keeps the plain path")
    # (a) generate + invert, (b) two inversions: 4 x STEPS UNet forwards
    _check_unet_launches(counts, 4 * STEPS)
    return counts, pipe, BATCH / walls[1]


def build_pipeline_768():
    t0 = time.perf_counter()
    pipe = paths.build_pipeline("sd-2-1")
    torch.cuda.synchronize()
    print(f"pipeline: sd-2-1 ({pipe.schedule.prediction_type}), built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if pipe.schedule.prediction_type != "v_prediction":
        raise AssertionError("sd-2-1 must run the v-prediction schedule")
    return pipe


def phase_generation_768(card: str, pipe) -> dict:
    from gswm_torch import recover_message_bits

    dev = "cuda"
    b = BATCH_768
    cfg = paths.config(RES_768, "gswm_torch 768")
    prompt_ids = paths.prompt_ids(pipe, b)

    torch.cuda.reset_peak_memory_stats()
    _clear_keystream_caches()
    _reset_counters()
    forwards = 0
    # (a), (b): latent closed loops, guidance 1.0
    for scheduler in ("DDIM", "DPMs"):
        zt, msg = paths.embed(cfg, b, 11)
        x0 = pipe.generate(zt, guidance_scale=1.0, num_steps=STEPS,
                           scheduler=scheduler, decode=False)
        z_back = pipe.invert(latents=x0, num_steps=STEPS, scheduler=scheduler)
        acc = _bit_accuracy(recover_message_bits(z_back, cfg), msg, dev)
        forwards += 2 * STEPS
        print(f"({'a' if scheduler == 'DDIM' else 'b'}) 768 closed loop, "
              f"{scheduler}, batch {b}, {STEPS}+{STEPS} steps: bit accuracy {acc}",
              flush=True)
        if min(acc) < MIN_BIT_ACC:
            raise AssertionError(f"{scheduler} closed-loop bit accuracy {acc} "
                                 f"below {MIN_BIT_ACC}")

    # (c): the watermark chain, twice (the second pass is timed).  One K4
    # launch per VAE chunk: at 768x768 the decoder takes 1 image a call and
    # the encoder 14
    pixels = max(1.0, RES_768 * RES_768 / (512 * 512))
    dec_want = -(-b // max(1, int(VAE_CHUNK / (8 * pixels))))
    enc_want = -(-b // max(1, int(VAE_CHUNK / pixels)))
    for attempt in (1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k4_0 = _counters()["flash_attention_split"]
        images, msg = paths.generate_watermarked(pipe, cfg, prompt_ids, 20 + attempt)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        k4_dec = _counters()["flash_attention_split"] - k4_0
        bits, z_t = pipe.extract_bits(cfg, images=images, num_steps=STEPS)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        k4_enc = _counters()["flash_attention_split"] - k4_0 - k4_dec
        forwards += 2 * STEPS
        if attempt == 1:
            first = (t1 - t0, t2 - t1)
            if (k4_dec, k4_enc) != (dec_want, enc_want):
                raise AssertionError(
                    f"K4 launches: decoder {k4_dec}, encoder {k4_enc}; the chunk "
                    f"rule gives {dec_want} and {enc_want}")
    if tuple(images.shape) != (b, 3, RES_768, RES_768):
        raise AssertionError(f"images shape {tuple(images.shape)}")
    if not torch.isfinite(images).all() or images.min() < 0 or images.max() > 1:
        raise AssertionError("images not finite in [0, 1]")
    if tuple(bits.shape) != (b, 256) or not torch.isfinite(z_t).all():
        raise AssertionError(f"bits shape {tuple(bits.shape)} or non-finite z_T")
    counts = _counters()
    peak = torch.cuda.max_memory_allocated() / 2**30
    acc = _bit_accuracy(bits, msg, dev)
    print(f"(c) 768 watermark chain, batch {b}: bit accuracy {acc} (no limit: a "
          f"random-weight VAE is not an autoencoder, so this says nothing about "
          f"the watermark)", flush=True)
    print(f"(c) generation (prompt, 30-step DDIM at guidance 7.5, VAE decode) "
          f"{t1 - t0:.4f} s = {b / (t1 - t0):.4f} images/s; extraction (VAE "
          f"encode, 30-step inversion, decode) {t2 - t1:.4f} s = "
          f"{b / (t2 - t1):.4f} images/s; first pass {first[0]:.4f} + "
          f"{first[1]:.4f} s; peak device memory {peak:.2f} GiB; on {card}",
          flush=True)
    print(f"launches on the 768x768 generation path: {counts}; K4 per chain: "
          f"decoder {k4_dec}, encoder {k4_enc}", flush=True)
    for name in ("chacha20", "fused_qkv_attention", "flash_attention",
                 "flash_attention_split"):
        if counts[name] < 1:
            raise AssertionError(f"kernel {name} never launched on the 768 path")
    # one keystream for four embeds and four decodes under one key
    if counts["chacha20"] != 1:
        raise AssertionError(f"K3 launched {counts['chacha20']} times on the 768 path; "
                             "the cached keystream makes it 1")
    _check_unet_launches(counts, forwards)
    return counts


def phase_tiers(card: str, pipe) -> dict:
    from gswm_torch import recover_message_bits

    dev = "cuda"
    b = BATCH_768
    cfg = paths.config(RES_768, "gswm_torch tiers")
    inputs = paths.unet_inputs(pipe, b)
    steps = paths.TIER_LOOP_STEPS

    def forward():
        with torch.inference_mode():
            return pipe.unet(*inputs)

    with paths.route_switches({}):
        default = forward()
        default_ms = _time_ms(forward, 10)
    top = default.abs().max().item()
    print(f"5. default route: UNet forward {default_ms:.4f} ms at batch {b}, "
          f"max|out| {top:.4f}; on {card}", flush=True)
    total = {name: 0 for name in _counters()}
    for label, switches in paths.TIER_SWITCHES.items():
        per_forward = TIER_LAUNCHES[label]
        with paths.route_switches(switches):
            _reset_counters()
            out = forward()
            torch.cuda.synchronize()
            one = _counters()
            ms = _time_ms(forward, 10)
            _reset_counters()
            zt, msg = paths.embed(cfg, b, 31)
            x0 = pipe.generate(zt, guidance_scale=1.0, num_steps=steps, decode=False)
            z_back = pipe.invert(latents=x0, num_steps=steps)
            acc = _bit_accuracy(recover_message_bits(z_back, cfg), msg, dev)
            loop = _counters()
        diff = (out - default).abs().max().item()
        env = " ".join(f"{k}={v}" for k, v in switches.items())
        print(f"({label}) {env}: max|out - default| {diff:.5f}, relative "
              f"{diff / top:.5f} (bound {TIER_REL_BOUND}); UNet forward {ms:.4f} ms; "
              f"closed loop {steps}+{steps} steps bit accuracy {acc}; launches per "
              f"forward {({k: v for k, v in one.items() if v})}", flush=True)
        want = {name: per_forward.get(name, 0) for name in ATTENTION_COUNTERS}
        if {name: one[name] for name in ATTENTION_COUNTERS} != want:
            raise AssertionError(f"({label}) launches per forward {one}, want {want}")
        if {name: loop[name] for name in ATTENTION_COUNTERS} != \
                {name: n * 2 * steps for name, n in want.items()}:
            raise AssertionError(f"({label}) launches over the closed loop {loop}")
        if loop["chacha20"]:
            raise AssertionError(f"({label}) K3 launched {loop['chacha20']} times; phase "
                                 "4 left this key's keystream cached")
        if not diff <= TIER_REL_BOUND * top:
            raise AssertionError(f"({label}) UNet output {diff} from the default "
                                 f"route's, above {TIER_REL_BOUND} x {top}")
        if min(acc) < MIN_BIT_ACC:
            raise AssertionError(f"({label}) closed-loop bit accuracy {acc} below "
                                 f"{MIN_BIT_ACC}")
        for name in total:
            total[name] += loop[name]
    return total


def phase_groupnorm_op(pipe) -> dict:
    """K8 on the real inputs of the 768x768 path's GroupNorms, held against
    each module's own output (F.group_norm in fp32, rounded to bf16): within
    GN_REL_BOUND of max |want| — two bf16 roundings of fp32 values that
    differ in the last places may land one bf16 step apart, at most 2^-7 of
    the entry; the absolute bound of phase 2 assumes outputs below 8, which
    real activations need not keep."""
    from gswm_torch.ops import groupnorm as gn

    worst = [0.0, 0]

    def hook(name, m, x, y):
        got = gn.fused_group_norm(x.contiguous(), m.weight, m.bias, m.num_groups, m.eps)
        err = (got.float() - y.float()).abs().max().item()
        top = y.float().abs().max().item()
        if not err <= GN_REL_BOUND * top:
            raise AssertionError(f"K8 at {name} {tuple(x.shape)}: error {err} above "
                                 f"{GN_REL_BOUND} x {top}")
        worst[0] = max(worst[0], err / top)
        worst[1] += 1

    _reset_counters()
    with paths.groupnorm_hooks(pipe, hook):
        paths.drive_groupnorm_sites(pipe)
    counts = _counters()
    print(f"6. K8 on {worst[1]} GroupNorm inputs of the 768x768 path: max "
          f"|err| / max|want| {worst[0]:.5f} (bound {GN_REL_BOUND}); launches "
          f"{counts['fused_group_norm']}", flush=True)
    if counts["fused_group_norm"] != worst[1] or worst[1] < 1:
        raise AssertionError(f"K8 launched {counts['fused_group_norm']} times for "
                             f"{worst[1]} GroupNorms")
    return counts


def phase_multikey(card: str, pipe) -> dict:
    """Per-user keys at config-5 scale; ``pipe``: sd-2-1-base."""
    import numpy as np

    from gswm_torch.core.multikey import (embed_latents_multikey,
                                          recover_message_bits_multikey)
    from gswm_torch.eval import trace

    dev = "cuda"
    n = paths.MULTIKEY_RECORDS
    per_call = paths.MULTIKEY_ROWS_PER_CALL
    cfg = paths.multikey_config()
    keys, nonces, messages, records = paths.multikey_material()
    want = torch.from_numpy(np.unpackbits(
        np.frombuffer(b"".join(messages), np.uint8)).reshape(n, 256)).to(dev)
    _reset_counters()

    # (a) embed and decode every record under its own key
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat = paths.multikey_embed_all(cfg, keys, nonces, messages)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    voted = paths.multikey_decode_all(cfg, lat, keys, nonces)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    exact = int((voted == want).all(dim=1).sum())
    m = paths.MULTIKEY_HOST_SLICE
    wrong = recover_message_bits_multikey(lat[:m], cfg, keys[1:m + 1], nonces[1:m + 1])
    wrong_acc = (wrong == want[:m]).float().mean(dim=1)
    calls = 2 * -(-n // per_call) + 1
    print(f"7. (a) {n} images under their own keys: embed {t1 - t0:.4f} s "
          f"({n / (t1 - t0):.1f} images/s), decode {t2 - t1:.4f} s "
          f"({n / (t2 - t1):.1f} images/s), {exact} of {n} exact; {m} rows under "
          f"the next row's key: accuracy {wrong_acc.min().item():.4f} ... "
          f"{wrong_acc.max().item():.4f}; latents {lat.numel() * 4 / 1e6:.0f} MB; "
          f"on {card}", flush=True)
    if tuple(lat.shape) != (n, 4, RES // 8, RES // 8) or not torch.isfinite(lat).all():
        raise AssertionError(f"multikey latents {tuple(lat.shape)} or not finite")
    if exact != n:
        raise AssertionError(f"only {exact} of {n} multikey decodes are exact")
    if wrong_acc.min() < 0.3 or wrong_acc.max() > 0.7:
        raise AssertionError("a row decoded under another row's key is not near 0.5")
    if _counters()["chacha20_batch"] != calls:
        raise AssertionError(f"batch kernel launched {_counters()['chacha20_batch']} "
                             f"times for {calls} batch_keystream_bits calls")

    # (b) trace probes against the whole registry
    probes = [int(i) for i in np.random.default_rng(7).choice(n, paths.MULTIKEY_PROBES,
                                                              replace=False)]
    probes[:2] = [5, m - 3]  # two inside the slice the host loop also scores
    chunks = -(-n // 4096)
    found = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in probes:
        c0 = _counters()["chacha20_batch"]
        found[i] = trace.find_source_device(lat[i], records)
        if _counters()["chacha20_batch"] - c0 != chunks:
            raise AssertionError(f"probe {i}: {_counters()['chacha20_batch'] - c0} "
                                 f"batch launches, not {chunks}")
    t_probe = (time.perf_counter() - t0) / len(probes)
    right = sum(found[i][:2] == (i, 1.0) for i in probes)
    runner_up = max(max(a for j, a in enumerate(found[i][2]) if j != i) for i in probes)
    print(f"   (b) find_source_device, {len(probes)} probes x {n} records: {right} of "
          f"{len(probes)} attributed at accuracy 1.0, best wrong record "
          f"{runner_up:.4f}; {t_probe:.4f} s a probe "
          f"({n / t_probe:.0f} candidates/s), {chunks} batch launches a probe",
          flush=True)
    if right != len(probes):
        raise AssertionError(f"only {right} of {len(probes)} probes attributed")

    # (c) the host loop on a slice: the same accuracies, exactly
    t0 = time.perf_counter()
    for i in probes[:2]:
        best, acc, accs = trace.find_source(lat[i], records[:m])
        if (best, acc) != (i, 1.0) or accs != found[i][2][:m]:
            raise AssertionError(f"probe {i}: the host loop and the batched search "
                                 "disagree on the slice")
    t_host = (time.perf_counter() - t0) / 2
    print(f"   (c) find_source (host loop), 2 probes x {m} records: accuracies equal "
          f"to (b)'s on the slice; {t_host:.4f} s a probe "
          f"({m / t_host:.0f} candidates/s)", flush=True)

    # (d) per-user keys through the model
    users = probes[2:2 + paths.MULTIKEY_MODEL_BATCH]
    pick = lambda xs: [xs[i] for i in users]  # noqa: E731
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zt, _ = embed_latents_multikey(cfg, pick(keys), pick(nonces), pick(messages),
                                   generator=torch.Generator(device=dev).manual_seed(43))
    x0 = pipe.generate(zt, guidance_scale=1.0, num_steps=STEPS, decode=False)
    z_back = pipe.invert(latents=x0, num_steps=STEPS)
    bits = recover_message_bits_multikey(z_back, cfg, pick(keys), pick(nonces))
    acc = (bits == want[users]).float().mean(dim=1).tolist()
    owners = [trace.find_source_device(z_back[j], records)[0] for j in range(len(users))]
    torch.cuda.synchronize()
    t_model = time.perf_counter() - t0
    print(f"   (d) {len(users)} images under {len(users)} keys through sd-2-1-base, "
          f"{STEPS}+{STEPS} steps: bit accuracy {acc}, attributed to {owners} (embedded "
          f"as {users}); {t_model:.4f} s", flush=True)
    if min(acc) < MIN_BIT_ACC:
        raise AssertionError(f"multikey closed-loop bit accuracy {acc} below {MIN_BIT_ACC}")
    if owners != users:
        raise AssertionError(f"recovered latents attributed to {owners}, not {users}")
    counts = _counters()
    want_calls = calls + chunks * (len(probes) + len(users)) + 2
    if counts["chacha20_batch"] != want_calls:
        raise AssertionError(f"batch kernel launched {counts['chacha20_batch']} times "
                             f"in phase 7; its calls make it {want_calls}")
    _check_unet_launches(counts, 2 * STEPS)
    return counts


def phase_fit(card: str) -> dict:
    """sd-2-1-base's VAE from a seed, fitted for encode-decode identity
    through ``fit_vae_roundtrip`` (fp32 masters, bf16 autocast, both fit
    switches): sign fidelity before and after, steps/s and peak memory a
    stage.  Returns the fitted float32 state and the launches of the
    fidelity reading after the fit (the fit itself launches none)."""
    from gswm_torch.tools import fit_vae

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    vae = fit_vae.build_vae(paths.FIT_PRESET, dev, paths.FIT_SEED)
    n = sum(p.numel() for p in vae.parameters())
    print(f"fit. VAE of {paths.FIT_PRESET}: {n / 1e6:.1f}M float32 parameters, built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    def fidelity(hw):
        return fit_vae.sign_fidelity(fit_vae.compute_copy(vae), (hw, hw),
                                     batch=fit_vae.fid_batch(hw))

    before = {hw: fidelity(hw) for hw in paths.FIDELITY_BEFORE}
    print(f"   sign fidelity before the fit (bf16 copy): "
          f"{ {f'{hw}x{hw}': round(v, 4) for hw, v in before.items()} }", flush=True)
    full = dict((hw, steps) for hw, steps, _, _ in fit_vae.parse_stages(fit_vae.STAGES))
    _reset_counters()
    for hw, steps, batch, lr in paths.FIT_STAGES:
        r = fit_vae.run_stage(vae, hw, steps, batch, lr)
        print(f"   {fit_vae.format_stage(r)} (N = {steps} of the tool's {full[hw]} "
              f"steps); on {card}", flush=True)
    counts = _counters()
    if any(counts.values()):
        raise AssertionError(f"the fit launched kernels: {counts}; no kernel has a "
                             "backward, the fit must run none")
    after = {hw: fidelity(hw) for hw in paths.FIDELITY_AFTER}
    counts = _counters()
    print(f"   sign fidelity after the fit (bf16 copy): "
          f"{ {f'{hw}x{hw}': round(v, 4) for hw, v in after.items()} }; the "
          f"96x96 reading's launches {({k: v for k, v in counts.items() if v})}",
          flush=True)
    if not (after[64] >= MIN_FIDELITY_64 and after[64] > before[64]):
        raise AssertionError(f"sign fidelity at 64x64 {after[64]} after the fit: below "
                             f"{MIN_FIDELITY_64} or not above its {before[64]} before")
    if counts["flash_attention_split"] != 2:
        raise AssertionError(f"K4 launched {counts['flash_attention_split']} times in "
                             "the 96x96 reading (one decode, one encode), not 2")
    return {k: v.detach().clone() for k, v in vae.state_dict().items()}, counts


def phase_cli(card: str, fitted: dict, rate_3b: float) -> dict:
    """The command-line path, sd-2-1-base at 512x512 on the fitted VAE:
    gs-embed-torch once a key into one directory (its registry then holds
    four records), the four images generated as one batch of 4, each key's
    image through gs_extract's device side (``extract_arrays``), and
    gs_trace's (``attribute_arrays``) against the registry gs-embed-torch
    wrote.  PNG encode and decode (PIL) are the one part of the CLI path
    the card does not run: its machine has no PIL, so the images pass as
    tensors; the CPU tests run the whole CLI, PIL included."""
    import numpy as np

    from gswm_torch.cli import gs_embed, gs_extract, gs_trace

    n, res, mb = len(paths.CLI_KEYS), RES, paths.CLI_MESSAGE_BITS
    geometry = ["--width", str(res), "--height", str(res), "--message_length", str(mb)]
    with tempfile.TemporaryDirectory() as tmp:
        _clear_keystream_caches()
        _reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        latents = []
        for i, (key, nonce) in enumerate(zip(paths.CLI_KEYS, paths.CLI_NONCES)):
            gs_embed.main(["--key_hex", key, "--nonce_hex", nonce, "--message",
                           f"user {i}", "--n_samples", "1", "--seed",
                           str(paths.CLI_SEED + i), "--outdir", tmp, "--device", "cuda",
                           *geometry])
            latents.append(np.load(os.path.join(tmp, "gs_latents.npy")))
        registry = os.path.join(tmp, "info_data.jsonl")
        records = gs_trace.load_registry(registry)
        t_embed = time.perf_counter() - t0
        k3_embed = _counters()["chacha20"]

        xargs = [gs_extract.build_parser().parse_args(
            ["--key_hex", r["key_hex"], "--nonce_hex", r["nonce_hex"],
             "--original_message_hex", r["message_hex"], "--num_inference_steps",
             str(STEPS), "--device", "cuda", *geometry]) for r in records]
        pipe = gs_extract.make_pipeline(xargs[0])
        pipe.vae.load_state_dict(fitted)
        pipe.weights_loaded_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images = pipe.generate(torch.from_numpy(np.concatenate(latents)).cuda(),
                               guidance_scale=1.0, num_steps=STEPS)
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
        accs, t_ext = [], []
        for i, args in enumerate(xargs):
            t0 = time.perf_counter()
            (bits, acc), = gs_extract.extract_arrays(pipe, gs_extract.make_config(args), args,
                                                     images[i:i + 1])
            torch.cuda.synchronize()
            t_ext.append(time.perf_counter() - t0)
            accs.append(acc)
        targs = gs_trace.build_parser().parse_args(
            ["--registry", registry, "--num_inference_steps", str(STEPS), "--device",
             "cuda", *geometry])
        t0 = time.perf_counter()
        attributed = gs_trace.attribute_arrays(pipe, records, targs, images)
        torch.cuda.synchronize()
        t_trace = time.perf_counter() - t0
    counts = _counters()
    del pipe
    print(f"cli. {n} keys through gs-embed-torch ({t_embed:.4f} s, {len(records)} registry "
          f"records), one generation of batch {n} at {res}x{res}, {STEPS} steps "
          f"({t_gen:.4f} s = {n / t_gen:.4f} images/s), gs-extract-torch's "
          f"extract_arrays a key at batch 1 ({sum(t_ext):.4f} s = {n / sum(t_ext):.4f} "
          f"images/s: the first key, the pipeline's first batch-1 inversion, "
          f"{t_ext[0]:.4f} s = {1 / t_ext[0]:.4f} images/s, the other {n - 1} warm "
          f"{sum(t_ext[1:]):.4f} s = {(n - 1) / sum(t_ext[1:]):.4f} images/s; "
          f"sd-2-1-base's extraction chain at batch 4 in phase 3b: {rate_3b:.4f} "
          f"images/s), gs-trace-torch's attribute_arrays on the batch ({t_trace:.4f} s); "
          f"on {card}", flush=True)
    print(f"   bit accuracy {accs}; attributions (record, accuracy) {attributed}; "
          f"launches {({k: v for k, v in counts.items() if v})}", flush=True)
    if not sum(accs) / n >= MIN_BIT_ACC:
        raise AssertionError(f"CLI bit accuracy {accs}: mean below {MIN_BIT_ACC}")
    if [best for best, _ in attributed] != list(range(n)):
        raise AssertionError(f"CLI attributions {attributed}: not each image to its key")
    if k3_embed != n or counts["chacha20"] != n:
        raise AssertionError(f"K3 launched {k3_embed} times in {n} embeds and "
                             f"{counts['chacha20']} in the phase; once a key makes it {n}")
    if counts["chacha20_batch"] != n:
        raise AssertionError(f"the batch kernel launched {counts['chacha20_batch']} "
                             f"times; one a probe against {n} records makes it {n}")
    # generation of the batch, one inversion a key, one inversion of the batch
    _check_unet_launches(counts, STEPS * (1 + n + 1))
    return counts


def _check_attacks(card: str) -> float:
    """8a.  Returns the summed ms of one call of each attack."""
    from gswm_torch import roofline
    from gswm_torch.distortions import device as attacks
    from gswm_torch.distortions import relative_strength_to_absolute

    cpu_images = paths.attack_images()
    images = cpu_images.cuda()
    # an elementwise attack reads the images once and writes them once
    bound = roofline.bound_ms(0, 2 * images.numel() * 4, roofline.PEAK_FP32)[0]
    total = 0.0
    for name in paths.attack_names():
        strength = relative_strength_to_absolute(paths.ATTACK_REL_STRENGTH, name)
        draws = paths.attack_draws(name, cpu_images.shape)
        on_card = paths.to_device(draws, "cuda")
        got = attacks.apply(images, name, strength, draws=on_card)
        want = attacks.apply(cpu_images, name, strength, draws=draws)
        worst, share = paths.attack_disagreement(name, got.cpu(), want)
        ms = _time_ms(lambda: attacks.apply(images, name, strength, draws=on_card), 5)
        total += ms
        print(f"   {name} at {strength:g}: card vs CPU max|diff| {worst:.2e}, share "
              f"beyond {paths.ATTACK_ATOL:g}: {share:.2e}; {ms:.4f} ms a call (bytes "
              f"bound of an elementwise pass {bound:.4f})", flush=True)
        del got, want
    size, via = (RES_768, RES_768), (paths.RESIZE_VIA, paths.RESIZE_VIA)

    def round_trip(x):
        return attacks.resize_cubic(attacks.resize_cubic(x, via), size)

    worst, _ = paths.attack_disagreement("resize_cubic", round_trip(images).cpu(),
                                         round_trip(cpu_images))
    ms = _time_ms(lambda: round_trip(images), 5)
    print(f"   resize_cubic {RES_768} -> {paths.RESIZE_VIA} -> {RES_768}: card vs CPU "
          f"max|diff| {worst:.2e}; {ms:.4f} ms; 8. (a) 15 attacks summed {total:.4f} "
          f"ms a call each, on {card}", flush=True)
    return total


def phase_bench(card: str, pipe) -> dict:
    """The robustness bench on the 768x768 pipeline."""
    from gswm_torch import treering
    from gswm_torch.core import bits as bitops
    from gswm_torch.distortions import relative_strength_to_absolute
    from gswm_torch.eval import sweep
    from gswm_torch.utils.io import load_jsonlines

    dev = "cuda"
    b = BATCH_768
    attack_ms = _check_attacks(card)

    # (b) the short sweep
    cfg = paths.config(RES_768, "gswm_torch sweep")
    strength = paths.ATTACK_REL_STRENGTH
    regen = max(int(relative_strength_to_absolute(strength, "reversed")), 1)
    rows_want = len(sweep.DEFAULT_ATTACKS)
    forwards = STEPS + rows_want * STEPS + 2 * regen
    pixels = max(1.0, RES_768 * RES_768 / (512 * 512))
    enc_chunks = -(-b // max(1, int(VAE_CHUNK / pixels)))
    dec_chunks = -(-b // max(1, int(VAE_CHUNK / (8 * pixels))))
    k4_want = (rows_want + 1) * enc_chunks + 2 * dec_chunks
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "sweep.jsonl")
        _reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = sweep.run_sweep(
            pipe, cfg, batch=b, num_steps=STEPS, strengths=(strength,), jpeg="device",
            extract_steps_rows=(), out_jsonl=out,
            generator=torch.Generator(device=dev).manual_seed(paths.SWEEP_SEED))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counters()
        records = load_jsonlines(out)
    reference = paths.reference_rows_768(strength)
    for r in rows:
        print(f"   {r.attack} at {r.absolute_strength:g}: bit accuracy "
              f"{r.bit_accuracies}, mean {r.bit_accuracy_mean:.4f} (the reference's row "
              f"on its fitted VAE: {reference[r.attack]:.4f})", flush=True)
    row_s = wall * STEPS / forwards  # a row of one inversion
    print(f"   (b) sweep of {len(rows)} rows on the fitted VAE, batch {b}, {STEPS} steps, "
          f"{forwards} UNet forwards: wall {wall:.4f} s, {len(rows) / wall:.4f} rows/s, "
          f"{len(rows) * b / wall:.4f} images/s; a 30-forward row {row_s:.4f} s, of "
          f"which its attack {attack_ms / 15 / 1e3 / row_s:.6f} on average; launches "
          f"{({k: v for k, v in counts.items() if v})}; on {card}", flush=True)
    if not rows[0].bit_accuracy_mean >= MIN_FITTED_NONE:
        raise AssertionError(f"the none row reads {rows[0].bit_accuracy_mean} on the "
                             f"fitted VAE, below {MIN_FITTED_NONE}")
    if [r.attack for r in rows] != list(sweep.DEFAULT_ATTACKS):
        raise AssertionError(f"sweep rows {[r.attack for r in rows]}")
    fields = ["attack", "relative_strength", "absolute_strength", "bit_accuracy_mean",
              "bit_accuracies", "tpr_at_1e6", "scheduler"]
    if len(records) != rows_want or any(list(rec) != fields for rec in records) \
            or records[1]["bit_accuracies"] != rows[1].bit_accuracies:
        raise AssertionError("the sweep's jsonl does not read back as its rows")
    for r in rows:
        if len(r.bit_accuracies) != b or \
                not all(0.0 <= a <= 1.0 for a in r.bit_accuracies):  # false for nan
            raise AssertionError(f"row {r.attack}: accuracies {r.bit_accuracies}")
    _check_unet_launches(counts, forwards)
    if counts["flash_attention_split"] != k4_want or counts["flash_attention_split_d64"] \
            or counts["chacha20"] > 1 or counts["chacha20_batch"] \
            or counts["fused_group_norm"]:
        raise AssertionError(f"sweep launches {counts}; K4 should be {k4_want}, K3 at "
                             "most 1, the batch kernel and K8 0")
    # the control row is the pipeline's own extraction of the same images
    zt, msg = paths.embed(cfg, b, paths.SWEEP_SEED)
    images = pipe.generate(zt, guidance_scale=1.0, num_steps=STEPS)
    # a value attack bites by where the pixels lie: brightness at relative
    # strength 0.1 multiplies them by 2.5, so every pixel above 0.4 clips
    print(f"   the sweep's images on the fitted VAE: mean pixel "
          f"{images.mean().item():.4f}, share above 0.4 "
          f"{(images > 0.4).float().mean().item():.4f}, share above 1 / 14.5 "
          f"{(images > 1 / 14.5).float().mean().item():.4f}", flush=True)
    bits, _ = pipe.extract_bits(cfg, images=images, num_steps=STEPS)
    want = bitops.bytes_to_bits(msg)
    control = [float((v == want).mean()) for v in bits.cpu().numpy()]
    if rows[0].bit_accuracies != control:
        raise AssertionError(f"the none row {rows[0].bit_accuracies} is not "
                             f"pipe.extract_bits' {control}")

    # (c) the Tree-Ring loop on latents, marked and unmarked in one batch
    mask, pattern, marked, unmarked = paths.treering_material()
    _reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x0 = pipe.generate(torch.cat([marked, unmarked]), guidance_scale=1.0,
                       num_steps=STEPS, decode=False)
    z_back = pipe.invert(latents=x0, num_steps=STEPS)
    dist = treering.eval_watermark(z_back, pattern.repeat(2, 1, 1, 1),
                                   mask.repeat(2, 1, 1, 1)).tolist()
    p_marked = treering.get_p_value(z_back[:b], pattern, mask)
    p_unmarked = treering.get_p_value(z_back[b:], pattern, mask)
    wall_tr = time.perf_counter() - t0
    tr_counts = _counters()
    print(f"   (c) Tree-Ring, {b} marked + {b} unmarked latents, {STEPS}+{STEPS} steps: "
          f"FFT distance {dist[:b]} against {dist[b:]}, p-value {p_marked} against "
          f"{p_unmarked}; {wall_tr:.4f} s", flush=True)
    if not (max(dist[:b]) < min(dist[b:]) and max(p_marked) < 0.01
            and max(p_marked) < min(p_unmarked)):
        raise AssertionError("the Tree-Ring loop does not separate marked from unmarked")
    _check_unet_launches(tr_counts, 2 * STEPS)
    return {name: counts[name] + tr_counts[name] for name in counts}


def phase_sdxl(card: str) -> tuple:
    """sdxl-base at 1024x1024, batch 2: the latent closed loop, the
    watermark chain, the UNet forward's time; then the memory sweep on the
    same pipeline.  Returns (launch counts, the sweep's seconds)."""
    from gswm_torch import recover_message_bits

    dev = "cuda"
    b, res = paths.BATCH_1024, paths.RES_1024
    t0 = time.perf_counter()
    pipe = paths.build_pipeline("sdxl-base")
    torch.cuda.synchronize()
    n_unet = sum(p.numel() for p in pipe.unet.parameters())
    n_text = sum(p.numel() for m in (pipe.text, pipe.text2) for p in m.parameters())
    print(f"9. pipeline: sdxl-base, UNet {n_unet / 1e6:.1f}M params, text encoders "
          f"{n_text / 1e6:.1f}M, built in {time.perf_counter() - t0:.2f} s", flush=True)
    cfg = paths.config(res, "gswm_torch sdxl")
    ids = paths.prompt_ids(pipe, b)
    per_forward = {"fused_qkv_attention": SDXL_K1, "flash_attention": SDXL_K2}

    torch.cuda.reset_peak_memory_stats()
    # no cache cleared: the keystream of this capacity is not cached yet
    _reset_counters()
    # (a) the latent closed loop
    zt, msg = paths.embed(cfg, b, 51)
    x0 = pipe.generate(zt, guidance_scale=1.0, num_steps=STEPS, decode=False)
    z_back = pipe.invert(latents=x0, num_steps=STEPS)
    acc = _bit_accuracy(recover_message_bits(z_back, cfg), msg, dev)
    sign = ((z_back > 0) == (zt > 0)).float().mean().item()
    print(f"(a) SDXL closed loop, batch {b}, {res}x{res}, {STEPS}+{STEPS} steps: bit "
          f"accuracy {acc}, element sign agreement {sign:.4f}", flush=True)
    if min(acc) < MIN_BIT_ACC:
        raise AssertionError(f"SDXL closed-loop bit accuracy {acc} below {MIN_BIT_ACC}")
    forwards = 2 * STEPS

    # (b) the watermark chain, twice (the second pass is timed)
    pixels = max(1.0, res * res / (512 * 512))
    dec_want = -(-b // max(1, int(VAE_CHUNK / (8 * pixels))))
    enc_want = -(-b // max(1, int(VAE_CHUNK / pixels)))
    for attempt in (1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k4_0 = _counters()["flash_attention_split"]
        images, msg = paths.generate_watermarked(pipe, cfg, ids, 60 + attempt, b)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        k4_dec = _counters()["flash_attention_split"] - k4_0
        bits, z_t = pipe.extract_bits(cfg, images=images, num_steps=STEPS)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        k4_enc = _counters()["flash_attention_split"] - k4_0 - k4_dec
        forwards += 2 * STEPS
        if attempt == 1:
            first = (t1 - t0, t2 - t1)
        if (k4_dec, k4_enc) != (dec_want, enc_want):
            raise AssertionError(f"SDXL K4 launches: decoder {k4_dec}, encoder {k4_enc}; "
                                 f"the chunk rule gives {dec_want} and {enc_want}")
    if tuple(images.shape) != (b, 3, res, res):
        raise AssertionError(f"SDXL images shape {tuple(images.shape)}")
    if not torch.isfinite(images).all() or images.min() < 0 or images.max() > 1:
        raise AssertionError("SDXL images not finite in [0, 1]")
    if tuple(bits.shape) != (b, 256) or not torch.isfinite(z_t).all():
        raise AssertionError(f"SDXL bits shape {tuple(bits.shape)} or non-finite z_T")
    counts = _counters()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"(b) SDXL watermark chain, batch {b}: bit accuracy "
          f"{_bit_accuracy(bits, msg, dev)} (no limit: random VAE weights); generation "
          f"(prompt through both encoders, {STEPS}-step DDIM at guidance 7.5, VAE "
          f"decode) {t1 - t0:.4f} s = {b / (t1 - t0):.4f} images/s; extraction (VAE "
          f"encode, {STEPS}-step inversion, decode) {t2 - t1:.4f} s = "
          f"{b / (t2 - t1):.4f} images/s; first pass {first[0]:.4f} + {first[1]:.4f} s; "
          f"peak device memory {peak:.2f} GiB; on {card}", flush=True)
    print(f"launches on the SDXL path: {({k: v for k, v in counts.items() if v})}; K4 "
          f"per chain: decoder {k4_dec}, encoder {k4_enc}", flush=True)
    _check_unet_launches(counts, forwards, SDXL_K1, SDXL_K2)
    if counts["chacha20"] != 1:
        raise AssertionError(f"K3 launched {counts['chacha20']} times on the SDXL path; a "
                             "new capacity makes it exactly 1")
    if counts["flash_attention_split"] != 2 * (dec_want + enc_want) \
            or counts["flash_attention_split_d64"] or counts["chacha20_batch"] \
            or counts["fused_group_norm"]:
        raise AssertionError(f"SDXL launches {counts}: K4 {2 * (dec_want + enc_want)}, "
                             "K4 at D = 64, the batch kernel and K8 never")

    # (c) one UNet forward, batch 2 and 4 (guidance), outside the counted run
    for batch in (b, 2 * b):
        inputs = paths.unet_inputs(pipe, batch, res=res)

        def forward():
            with torch.inference_mode():
                return pipe.unet(*inputs)

        _reset_counters()
        out = forward()
        torch.cuda.synchronize()
        one = _counters()
        if {k: one[k] for k in per_forward} != per_forward:
            raise AssertionError(f"one SDXL forward launched {one}")
        if not torch.isfinite(out).all():
            raise AssertionError("SDXL UNet output not finite")
        ms = _time_ms(forward, 5)
        print(f"(c) SDXL UNet forward, batch {batch}, {res}x{res}: {ms:.4f} ms; on {card}",
              flush=True)
    t0 = time.perf_counter()
    sweep = phase_memory_sweep(card, pipe, "sdxl-base", arch="sdxl")
    del pipe
    return {name: counts[name] + sweep[name] for name in counts}, time.perf_counter() - t0


def _by_d_since(before: dict) -> dict:
    """The attention launches by head dim since ``before`` (_counters_by_d),
    the wrappers that launched none left out."""
    now = _counters_by_d()
    made = {name: {d: n - before[name].get(d, 0) for d, n in per.items()
                   if n != before[name].get(d, 0)} for name, per in now.items()}
    return {name: per for name, per in made.items() if per}


def phase_sd14(card: str, rate_3b: float) -> dict:
    """sd-1-4 at 512x512, batch 4: the latent closed loop, the watermark
    chain, one UNet forward under three switch sets, the forward's time."""
    from gswm_torch import recover_message_bits
    from gswm_torch.models.layers import Attention

    dev = "cuda"
    b, res = paths.BATCH_SD14, paths.RES_512
    t0 = time.perf_counter()
    pipe = paths.build_pipeline("sd-1-4")
    torch.cuda.synchronize()
    n_unet = sum(p.numel() for p in pipe.unet.parameters())
    widths = sorted({m.head_dim for m in pipe.unet.modules() if isinstance(m, Attention)})
    print(f"10. pipeline: sd-1-4, UNet {n_unet / 1e6:.1f}M params, heads {widths} wide, "
          f"built in {time.perf_counter() - t0:.2f} s", flush=True)
    cfg = paths.config(res, "gswm_torch sd14")
    ids = paths.prompt_ids(pipe, b)

    torch.cuda.reset_peak_memory_stats()
    _clear_keystream_caches()
    _reset_counters()
    # (a) the latent closed loop
    zt, msg = paths.embed(cfg, b, 71)
    x0 = pipe.generate(zt, guidance_scale=1.0, num_steps=STEPS, decode=False)
    z_back = pipe.invert(latents=x0, num_steps=STEPS)
    acc = _bit_accuracy(recover_message_bits(z_back, cfg), msg, dev)
    sign = ((z_back > 0) == (zt > 0)).float().mean().item()
    print(f"(a) SD 1.x closed loop, batch {b}, {res}x{res}, {STEPS}+{STEPS} steps: bit "
          f"accuracy {acc}, element sign agreement {sign:.4f}", flush=True)
    if min(acc) < MIN_BIT_ACC:
        raise AssertionError(f"SD 1.x closed-loop bit accuracy {acc} below {MIN_BIT_ACC}")
    forwards = 2 * STEPS

    # (b) the watermark chain, twice (the second pass is timed)
    for attempt in (1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images, msg = paths.generate_watermarked(pipe, cfg, ids, 80 + attempt, b)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bits, z_t = pipe.extract_bits(cfg, images=images, num_steps=STEPS)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        forwards += 2 * STEPS
        if attempt == 1:
            first = (t1 - t0, t2 - t1)
    if tuple(images.shape) != (b, 3, res, res):
        raise AssertionError(f"SD 1.x images shape {tuple(images.shape)}")
    if not torch.isfinite(images).all() or images.min() < 0 or images.max() > 1:
        raise AssertionError("SD 1.x images not finite in [0, 1]")
    if tuple(bits.shape) != (b, 256) or not torch.isfinite(z_t).all():
        raise AssertionError(f"SD 1.x bits shape {tuple(bits.shape)} or non-finite z_T")
    counts, by_d = _counters(), _counters_by_d()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"(b) SD 1.x watermark chain, batch {b}: bit accuracy "
          f"{_bit_accuracy(bits, msg, dev)} (no limit: random VAE weights); generation "
          f"(prompt through CLIP-L, {STEPS}-step DDIM at guidance 7.5, VAE decode) "
          f"{t1 - t0:.4f} s = {b / (t1 - t0):.4f} images/s; extraction (VAE encode, "
          f"{STEPS}-step inversion, decode) {t2 - t1:.4f} s = {b / (t2 - t1):.4f} images/s "
          f"(sd-2-1-base's extraction chain in phase 3b: {rate_3b:.4f} images/s); first "
          f"pass {first[0]:.4f} + {first[1]:.4f} s; peak device memory {peak:.2f} GiB; on "
          f"{card}", flush=True)
    print(f"launches on the SD 1.x path: {({k: v for k, v in counts.items() if v})}; by "
          f"head dim {({k: v for k, v in by_d.items() if v})}", flush=True)
    want = {name: {d: n * forwards for d, n in per.items()}
            for name, per in SD14_PER_FORWARD.items()}
    if {name: per for name, per in by_d.items() if per} != want:
        raise AssertionError(f"SD 1.x launches by head dim {by_d} for {forwards} UNet "
                             f"forwards, want {want}")
    if counts["chacha20"] != 1 or counts["chacha20_batch"] or counts["fused_group_norm"]:
        raise AssertionError(f"SD 1.x launches {counts}: K3 once after the caches were "
                             "cleared, the batch kernel and K8 never")

    # (c) one forward under three switch sets against the default route's
    inputs = paths.unet_inputs(pipe, b, res=res)

    def forward():
        with torch.inference_mode():
            return pipe.unet(*inputs)

    with paths.route_switches({}):
        before = _counters_by_d()
        default = forward()
        torch.cuda.synchronize()
        made = _by_d_since(before)
    top = default.abs().max().item()
    if made != SD14_PER_FORWARD or not torch.isfinite(default).all():
        raise AssertionError(f"one SD 1.x forward launched {made}, or its output is "
                             "not finite")
    outs = {}
    for label, per_forward in SD14_TIER_LAUNCHES.items():
        switches = paths.TIER_SWITCHES[label]
        with paths.route_switches(switches):
            before = _counters_by_d()
            out = outs[label] = forward()
            torch.cuda.synchronize()
            made = _by_d_since(before)
        diff = (out - default).abs().max().item()
        env = " ".join(f"{k}={v}" for k, v in switches.items())
        print(f"(c, {label}) {env}: max|out - default| {diff:.5f}, relative "
              f"{diff / top:.5f} (bound {TIER_REL_BOUND}); launches by head dim {made}",
              flush=True)
        if made != per_forward:
            raise AssertionError(f"({label}) SD 1.x launches {made}, want {per_forward}")
        if not diff <= TIER_REL_BOUND * top:
            raise AssertionError(f"({label}) SD 1.x UNet output {diff} from the default "
                                 f"route's, above {TIER_REL_BOUND} x {top}")
    diff = (outs["c"] - outs["a"]).abs().max().item()
    print(f"(c) against (a): max|out_c - out_a| {diff:.5f}, relative {diff / top:.5f} "
          f"(K7 against K2 at d = 40)", flush=True)
    del outs
    counts = _counters()

    # (d) one UNet forward, batch 4 and 8 (guidance), outside the counted run
    for batch in (b, 2 * b):
        inputs = paths.unet_inputs(pipe, batch, res=res)
        ms = _time_ms(forward, 10)
        print(f"(d) SD 1.x UNet forward, batch {batch}, {res}x{res}: {ms:.4f} ms; on "
              f"{card}", flush=True)
    del pipe
    return counts


def phase_memory_sweep(card: str, pipe, preset: str, arch: str = "sd",
                       check_steps: int = 0) -> dict:
    """The memory model of gswm_torch/utils/memory.py against the card: the
    extraction chain (embed, VAE encode, inversion, decode) at the batches of
    ``paths.MEMORY_SWEEPS[preset]``, 2 inversion steps, each batch's
    measured peak beside the model's; with ``check_steps``, the peak at the
    smallest batch with that many steps beside the 2-step one."""
    from gswm_torch.utils import memory

    res, batches = paths.MEMORY_SWEEPS[preset]
    steps = paths.MEMORY_STEPS
    cfg = paths.config(res, "gswm_torch memory")
    t0 = time.perf_counter()
    memory.chain_peaks(pipe, cfg, min(batches), steps)  # the first call at these shapes
    _clear_keystream_caches()
    _reset_counters()
    forwards, k4_want = 0, 0
    for b in batches:
        peaks = memory.chain_peaks(pipe, cfg, b, steps, seed=b)
        forwards += steps
        if res > RES:  # the VAE mid attention above 4096 tokens: K4 a chunk
            k4_want += -(-b // pipe._vae_chunk_for(torch.empty((b, 3, res, res),
                                                               device="meta")))
        want = memory.predicted_peak_gib(res, b, arch)
        print(f"memory {preset} {res}x{res} batch {b}: peak {peaks['chain']:.4f} GiB (encode "
              f"{peaks['encode']:.4f}, inversion {peaks['invert']:.4f}), model {want:.4f} "
              f"({want / peaks['chain'] - 1:+.2%}); {peaks['images_per_s']:.4f} images/s at "
              f"{steps} steps; on {card}", flush=True)
        if abs(want / peaks["chain"] - 1) > MEMORY_REL_BOUND:
            raise AssertionError(f"memory model {want:.4f} GiB at {preset} batch {b} is off "
                                 f"the measured {peaks['chain']:.4f} by more than "
                                 f"{MEMORY_REL_BOUND:.0%}")
    if check_steps:
        b = min(batches)
        long = memory.chain_peaks(pipe, cfg, b, check_steps, seed=b)["chain"]
        short = memory.chain_peaks(pipe, cfg, b, steps, seed=b)["chain"]
        forwards += check_steps + steps
        print(f"memory {preset} batch {b}: peak {long:.4f} GiB at {check_steps} steps, "
              f"{short:.4f} at {steps} ({long / short - 1:+.4%})", flush=True)
        if abs(long / short - 1) > STEPS_PEAK_BOUND:
            raise AssertionError(f"the peak moves with the step count: {long} against {short}")
    counts = _counters()
    per_forward = (SDXL_K1, SDXL_K2) if arch == "sdxl" else (10, 5)
    _check_unet_launches(counts, forwards, *per_forward)
    if counts["chacha20"] != 1 or counts["flash_attention_split"] != k4_want:
        raise AssertionError(f"memory sweep launches {counts}: K3 once, K4 {k4_want}")
    print(f"memory sweep {preset}: {time.perf_counter() - t0:.2f} s; launches "
          f"{({k: v for k, v in counts.items() if v})}", flush=True)
    return counts


def phase_suggested_batch(card: str) -> dict:
    """sd-2-1-base's extraction chain at ``suggest_batch(512)`` for this
    card, 2 inversion steps, alone on the card (a pipeline built anew after
    every other is freed): its peak under 90% of the card's memory."""
    from gswm_torch.utils import memory

    torch.cuda.empty_cache()
    total = memory.card_gib()
    b = memory.suggest_batch(RES)
    pipe = paths.build_pipeline("sd-2-1-base")
    cfg = paths.config(RES, "gswm_torch suggested")
    _clear_keystream_caches()
    _reset_counters()
    peaks = memory.chain_peaks(pipe, cfg, b, paths.MEMORY_STEPS)
    counts = _counters()
    want = memory.predicted_peak_gib(RES, b)
    print(f"suggested batch at {RES}x{RES} for {total:.4f} GiB: {b}; peak {peaks['chain']:.4f} "
          f"GiB ({peaks['chain'] / total:.2%} of the card; model {want:.4f}), allocator "
          f"reserved {peaks['reserved']:.4f} GiB; {peaks['images_per_s']:.4f} images/s at "
          f"{paths.MEMORY_STEPS} steps (embed, VAE encode, inversion, decode); on {card}",
          flush=True)
    if peaks["chain"] >= 0.9 * total:
        raise AssertionError(f"the suggested batch {b} peaks at {peaks['chain']:.4f} GiB, "
                             f"over 90% of {total:.4f}")
    _check_unet_launches(counts, paths.MEMORY_STEPS)
    if counts["chacha20"] != 1:
        raise AssertionError(f"K3 launched {counts['chacha20']} times at the suggested batch")
    print(f"launches at the suggested batch {({k: v for k, v in counts.items() if v})}",
          flush=True)
    del pipe
    torch.cuda.empty_cache()
    return counts


def phase_quality(card: str, pipe) -> tuple:
    """Phase 11 (a) and (b) on sd-2-1-base at 512x512: the lossless
    artifact, then the CLIP score of its images on the card against the
    CPU.  Returns (counts, the wm_indep images as numpy)."""
    from gswm_torch.eval import quality
    from gswm_torch.models import clip
    from gswm_torch.tools import run_quality_artifact as artifact

    b = paths.QUALITY_BATCH
    t0 = time.perf_counter()
    _clear_keystream_caches()
    _reset_counters()
    rows, (images, _, _) = artifact.run(pipe, RES, b, STEPS, seed=paths.QUALITY_SEED,
                                        log=lambda s: print(f"(a) {s}", flush=True))
    counts = _counters()
    latent = next(r for r in rows if r["space"] == "latent" and r["population"] == "wm_indep")
    (study,) = artifact.latent_seed_study(pipe, RES, b, [paths.QUALITY_SEED])
    print(f"(a) the plain population against the exact N(0, 1): p "
          f"{study['plain_ks1_normal_p']:.4f}", flush=True)
    print(f"(a) lossless artifact, 3 x {b} images, {STEPS} steps, seed {paths.QUALITY_SEED}: "
          f"{time.perf_counter() - t0:.2f} s; launches "
          f"{({k: v for k, v in counts.items() if v})}; on {card}", flush=True)
    for r in rows:
        print(f"(a) row {json.dumps(r)}", flush=True)
    if min(latent["ks1_normal_p"], latent["ks2_p"]) < paths.QUALITY_MIN_P:
        raise AssertionError(f"wm_indep's latent KS p-values {latent['ks1_normal_p']}, "
                             f"{latent['ks2_p']}: below {paths.QUALITY_MIN_P}")
    if len(rows) != 4 or images.shape != (b, 3, RES, RES) or not np.isfinite(images).all():
        raise AssertionError("the artifact's rows or images are malformed")
    # three generations of 30 steps; one keystream a nonce: wm_fixed's and b
    # of wm_indep's, the caches cleared first
    _check_unet_launches(counts, 3 * STEPS)
    if counts["chacha20"] != b + 1 or counts["flash_attention_split"]:
        raise AssertionError(f"artifact launches {counts}: K3 {b + 1}, K4 none")

    # (b) the CLIP score at ViT-L/14's widths, random weights from a seed,
    # through a checkpoint directory written here: the card against the CPU
    t0 = time.perf_counter()
    model = clip.build_clip(paths.CLIP_VIT_L14, torch.Generator().manual_seed(paths.CLIP_SEED),
                            device="cpu")
    n_params = sum(p.numel() for p in model.parameters())
    directory = paths.write_clip_dir(os.path.join("build", "clip_vit_l14_random"), model)
    del model
    prompts = list(paths.CLIP_PROMPTS)
    want = quality.measure_similarity(images, prompts, directory, device="cpu")
    cpu_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = quality.measure_similarity(images, prompts, directory, device="cuda")
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    walls = []
    for _ in range(CLIP_TIMED_CALLS):
        t1 = time.perf_counter()
        quality.measure_similarity(images, prompts, directory, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    err = float(np.abs(got - want).max())
    print(f"(b) CLIP ViT-L/14 ({n_params / 1e6:.1f}M params, fp32, TF32 off) on {b} images "
          f"and {len(prompts)} prompts: scores {np.round(got, 5).tolist()}; max |card - CPU| "
          f"{err:.2e}; {statistics.median(walls) * 1e3:.2f} ms a call on the card (median of "
          f"{CLIP_TIMED_CALLS}, host clock, processing included), device memory "
          f"{peak:.4f} GiB above the resident at the first call (weights included); the "
          f"checkpoint written and the CPU's call {cpu_s:.2f} s; on {card}", flush=True)
    if err > CLIP_CARD_BOUND or got.shape != (b,) or not np.isfinite(got).all():
        raise AssertionError(f"CLIP scores on the card off the CPU's by {err}")
    quality._load_clip.cache_clear()
    return counts, images


def phase_integrations(card: str, pipe) -> dict:
    """Phase 11 (c): the ComfyUI nodes, the A1111 noise and the ComfyUI
    sampler's noise substitution on the card; each latent decoded (1.0),
    then 30-step generate at guidance 1.0 and 30-step inversion (>= 0.99).
    ``stage`` / ``stage_report`` / ``device_stats`` around it, a trace of
    the embeds into build/."""
    import contextlib
    import types

    from gswm_torch import GSConfig, recover_message_bits
    from gswm_torch.config import prepare_message_bytes
    from gswm_torch.integrations import a1111, comfyui
    from gswm_torch.utils import profiling

    dev = "cuda"
    t0 = time.perf_counter()
    keys = {name: f"{0x71 + i:02x}" * 32 for i, name in enumerate(("node", "a1111", "sampler"))}
    nonce = "72" * 16
    lats, cfgs, msgs = [], [], []

    def add(lat, key, message, repeat=False):
        lats.append(torch.as_tensor(lat).to(dev, torch.float32).reshape(-1, 4, RES // 8,
                                                                        RES // 8))
        cfg = GSConfig(key_hex=key, nonce_hex=nonce, message=message, width=RES,
                       height=RES, message_bits=256, repeat4=repeat)
        cfgs.extend([cfg] * lats[-1].shape[0])
        msgs.extend([prepare_message_bytes(message, 32, repeat)] * lats[-1].shape[0])

    calls = []
    sample = types.SimpleNamespace(
        prepare_noise=lambda *a: None,
        sample=lambda model, noise, *a, **kw: calls.append(noise) or noise)
    comfy = types.SimpleNamespace(sample=sample,
                                  utils=types.SimpleNamespace(PROGRESS_BAR_ENABLED=False))
    stubs = {"comfy": comfy, "comfy.sample": sample, "comfy.utils": comfy.utils,
             "latent_preview": types.SimpleNamespace(prepare_callback=lambda m, s: None)}
    trace_dir = os.path.abspath(TRACE_DIR)
    _clear_keystream_caches()
    _reset_counters()
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        with profiling.trace(trace_dir, device=dev), \
                profiling.stage("11c embeds", device=dev):
            node = comfyui.GSLatent()
            for use_seed in (1, 0):
                latent, preview = node.create_gs_latents(
                    key=keys["node"], nonce=nonce, message="comfy node", batch_size=4,
                    use_seed=use_seed, seed=31, width=RES, height=RES, message_length=256)
                if latent["samples"].device.type != "cpu" or \
                        latent["samples"].dtype != torch.float32 or \
                        tuple(preview.shape) != (4, RES // 8, RES // 8, 3):
                    raise AssertionError("GSLatent's LATENT is not float32 on the CPU")
                if use_seed == 1 and not torch.equal(latent["samples"][0],
                                                     latent["samples"][3]):
                    raise AssertionError("GSLatent's seeded batch is not replicated")
                add(latent["samples"], keys["node"], "comfy node")
            for repeat in (False, True):
                lat = a1111.gs_noise_batch("webui", keys["a1111"], nonce, seed=41,
                                           use_random_seed=True, use_repeat=repeat)
                if lat.device.type != "cuda" or tuple(lat.shape) != (4, RES // 8, RES // 8):
                    raise AssertionError("gs_noise_batch's latent is not on the card")
                add(lat, keys["a1111"], "webui", repeat)
            (gs, _) = node.create_gs_latents(
                key=keys["sampler"], nonce=nonce, message="sampler", batch_size=2,
                use_seed=0, seed=0, width=RES, height=RES, message_length=256)
            saved = {name: sys.modules.get(name) for name in stubs}
            sys.modules.update(stubs)
            try:
                (out,) = comfyui.common_ksampler(
                    None, 5, STEPS, 1.0, "ddim", "normal", [], [],
                    {"samples": torch.zeros_like(gs["samples"])}, use_GS=True,
                    GS_latent_noise=gs)
            finally:
                for name, mod in saved.items():
                    if mod is None:
                        sys.modules.pop(name, None)
                    else:
                        sys.modules[name] = mod
            if len(calls) != 1 or calls[0] is not gs["samples"]:
                raise AssertionError("common_ksampler did not hand the GS latent to the sampler")
            add(out["samples"], keys["sampler"], "sampler")
            torch.cuda.synchronize()
        if not os.path.exists("info_data.txt"):
            raise AssertionError("the integrations wrote no info_data.txt")
        records = open("info_data.txt").read().count("key: ")
    embed_counts = _counters()
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    # 1 + 4 node latents, 2 A1111 latents, 2 sampler latents: one record each
    if records != 9:
        raise AssertionError(f"{records} registry records, not 9")

    z = torch.cat(lats)
    with profiling.stage("11c decode", device=dev):
        acc = [_bit_accuracy(recover_message_bits(z[i:i + 1], cfg), msg, dev)[0]
               for i, (cfg, msg) in enumerate(zip(cfgs, msgs))]
    if min(acc) != 1.0:
        raise AssertionError(f"integration latents decode at {acc}, not 1.0")
    with profiling.stage("11c closed loop", device=dev):
        x0 = pipe.generate(z, guidance_scale=1.0, num_steps=STEPS, decode=False)
        z_back = pipe.invert(latents=x0, num_steps=STEPS)
    loop = [_bit_accuracy(recover_message_bits(z_back[i:i + 1], cfg), msg, dev)[0]
            for i, (cfg, msg) in enumerate(zip(cfgs, msgs))]
    report = profiling.stage_report(reset=True)
    stats = profiling.device_stats()
    counts = _counters()
    print(f"(c) integrations: {z.shape[0]} latents (GSLatent seeded 4 and unseeded 4, "
          f"gs_noise_batch plain and repeat, common_ksampler 2): decoded {min(acc)}; "
          f"through {STEPS}-step generate and inversion at batch {z.shape[0]}: "
          f"{[round(a, 4) for a in loop]}; {time.perf_counter() - t0:.2f} s; launches "
          f"{({k: v for k, v in counts.items() if v})}", flush=True)
    print(f"(c) stage_report {json.dumps(report)}; device_stats {json.dumps(stats)}; trace "
          f"{trace_dir}/trace.json: {len(events)} events, {kernels} kernels on the device",
          flush=True)
    if min(loop) < MIN_BIT_ACC:
        raise AssertionError(f"integration closed loop {loop} below {MIN_BIT_ACC}")
    if set(report) != {"11c embeds", "11c decode", "11c closed loop"} or \
            stats[0]["bytes_limit"] != torch.cuda.get_device_properties(0).total_memory:
        raise AssertionError(f"stage_report {report} or device_stats {stats} malformed")
    _check_unet_launches(counts, 2 * STEPS)
    # one keystream a key (three keys, one nonce, one capacity), the caches
    # cleared first: every later embed and decode takes it from the cache
    if counts["chacha20"] != len(keys) or embed_counts["chacha20"] != len(keys):
        raise AssertionError(f"K3 launched {counts['chacha20']} times for {len(keys)} keys")
    return counts


def _lse_library(q, k, v):
    """aten's flash attention, which returns its logsumexp beside the output,
    on (B, H, S, D) views: the yardstick of K4 with lse (d <= 256)."""
    return torch.ops.aten._scaled_dot_product_flash_attention(
        *(t.transpose(1, 2) for t in (q, k, v)))


def _ring_on_one_card(shards: tuple, sp: int, dtype) -> torch.Tensor:
    """ring_attention's per-rank step for every virtual rank of an sp ring,
    in ring order: at step j rank r holds k/v shard (r - j) % sp, what j
    rotations to the right neighbour bring it.  ``shards``: the q, k and v
    shards (lists of sp contiguous (B, S / sp, H, D) tensors)."""
    from gswm_torch.ops.ring_attention import ring_finish, ring_step

    qs, ks, vs = shards
    outs = []
    for r in range(sp):
        acc = None
        for step in range(sp):
            src = (r - step) % sp
            acc = ring_step(qs[r], ks[src], vs[src], acc)
        outs.append(ring_finish(acc, dtype))
    return torch.cat(outs, dim=1)


def phase_lse(card: str, records: dict) -> None:
    """12a: K4 with its log-sum-exp output against its plain version."""
    from gswm_torch import roofline
    from gswm_torch.ops import attention as attn

    g = torch.Generator(device="cuda").manual_seed(1212)
    for b, s, h, d in paths.LSE_SHAPES:
        for sq in (s, s // paths.LSE_SHARDS):
            q, k, v = (torch.randn((b, sq, h, d), generator=g, device="cuda").bfloat16()
                       for _ in range(3))
            label = f"12a K4 lse (B={b}, Sq={sq}, Sk={sq}, H={h}, D={d})"

            def fn(q=q, k=k, v=v):
                return attn.flash_attention_split(q, k, v, return_lse=True)

            out, lse = fn()
            want, want_lse = attn.flash_attention_split_lse_reference(q.float(), k.float(),
                                                                      v.float())
            err = (out.float() - want).abs().max().item()
            top = want.abs().max().item()
            lse_err = (lse - want_lse).abs().max().item()
            ok = err <= ATTN_BOUND and lse_err <= LSE_BOUND
            if sq < attn.SPLIT_MIN_KEYS:
                # the reference's einsum path rounds the logits to bf16 (~2^-9
                # of a logit of ~4): held to the absolute bound alone, the
                # relative one printed
                print(f"{label}: the wrapper's einsum branch ({sq} keys < "
                      f"{attn.SPLIT_MIN_KEYS}): max|err| {err:.5f} (bound {ATTN_BOUND}), "
                      f"err/max|want| {err / top:.5f}, lse max|err| {lse_err:.6f} (bound "
                      f"{LSE_BOUND})", flush=True)
            else:
                _check_every_head(label, out.float(), want)
                ok = ok and err <= ATTN_REL_BOUND * top
                ms = _time_ms(fn, 10)
                # the same kernel without the lse store, right after
                no_lse = _time_ms(lambda q=q, k=k, v=v: attn.flash_attention_split(q, k, v), 10)
                plain = _time_ms(lambda q=q, k=k, v=v: attn.flash_attention_split_lse_reference(
                    q.float(), k.float(), v.float()), 2, warmup=1)
                bound = roofline.attention_bound_ms(
                    roofline.attention_cost(b, sq, sq, h, d, lse=True))
                lib = _library_ms(lambda q=q, k=k, v=v: _lse_library(q, k, v), 10,
                                  "aten flash with lse") if d <= 256 else None
                print(f"{label}: max|err| {err:.5f} (bound {ATTN_BOUND}), err/max|want| "
                      f"{err / top:.5f} (bound {ATTN_REL_BOUND}), lse max|err| {lse_err:.6f} "
                      f"(bound {LSE_BOUND}); {ms:.4f} ms (without lse {no_lse:.4f}, plain "
                      f"{plain:.4f}, bound {bound[0]:.4f} by {bound[1]}, library {_fmt(lib)}); "
                      f"on {card}", flush=True)
                name = "flash_attention_split_lse_d64" if d <= 64 else "flash_attention_split_lse"
                _record(records, name, err, ms, plain, bound, lib)
                records[name]["max_lse_err"] = max(records[name].get("max_lse_err", 0.0),
                                                   lse_err)
            if not ok:
                raise AssertionError(f"{label}: error {err} (max|want| {top}) or lse error "
                                     f"{lse_err} above its bound")
            del q, k, v, out, lse, want, want_lse
    for name in ("flash_attention_split_lse_d64", "flash_attention_split_lse"):
        rec = records[name]
        rec["roof"] = max(rec["roof"], key=rec["roof"].get)
        rec["bound_by"] = "bytes" if rec["roof"] == "bytes" else "operations"


def phase_ring_one_card(card: str) -> dict:
    """12b: the ring's steps for every virtual rank on the one card, against
    one flash_attention_split call."""
    from gswm_torch.ops import attention as attn

    g = torch.Generator(device="cuda").manual_seed(1213)
    cases = []
    for b, s, h, d in paths.LSE_SHAPES:
        q, k, v = (torch.randn((b, s, h, d), generator=g, device="cuda").bfloat16()
                   for _ in range(3))
        for sp in paths.RING_SP:
            shards = tuple([c.contiguous() for c in t.chunk(sp, dim=1)] for t in (q, k, v))
            cases.append(((b, s, h, d), sp, (q, k, v), shards))
    # the path: each ring once, its launches counted
    _reset_counters()
    rings = [_ring_on_one_card(shards, sp, torch.bfloat16) for _, sp, _, shards in cases]
    torch.cuda.synchronize()
    counts = _counters()
    want_by_d = {}
    for (b, s, h, d), sp, _, _ in cases:
        if s // sp >= attn.SPLIT_MIN_KEYS:  # below, the einsum branch serves the shard
            want_by_d[d] = want_by_d.get(d, 0) + sp * sp
    got_by_d = dict(attn.flash_attention_split.lse_launches_by_d)
    print(f"12b ring on one card: K4-with-lse launches by head dim {got_by_d} (want "
          f"{want_by_d}); other attention launches "
          f"{({k: counts[k] for k in ATTENTION_COUNTERS if counts[k]})}", flush=True)
    if got_by_d != want_by_d or any(counts[k] for k in ATTENTION_COUNTERS):
        raise AssertionError(f"ring launches {got_by_d}, other attention {counts}")
    for ((b, s, h, d), sp, (q, k, v), shards), got in zip(cases, rings):
        single = attn.flash_attention_split(q, k, v).float()
        label = f"12b ring sp={sp} (B={b}, S={s}, H={h}, D={d})"
        err = (got.float() - single).abs().max().item()
        top = single.abs().max().item()
        # shards below 512 keys take the einsum branch, whose bf16 logits
        # 12a holds to the absolute bound alone
        kernel = s // sp >= attn.SPLIT_MIN_KEYS
        if kernel:
            _check_every_head(label, got.float(), single)
        ring_ms = _time_ms(lambda: _ring_on_one_card(shards, sp, torch.bfloat16), 3, warmup=1)
        one_ms = _time_ms(lambda: attn.flash_attention_split(q, k, v), 3, warmup=1)
        print(f"{label}: max|ring - one call| {err:.5f}, relative {err / top:.5f} (bounds "
              f"{ATTN_BOUND}{f', {ATTN_REL_BOUND}' if kernel else ''}; shards through "
              f"{'the kernel' if kernel else 'the einsum branch'}); ring wall {ring_ms:.4f} "
              f"ms ({sp * sp} steps) against one call {one_ms:.4f} ms; on {card}", flush=True)
        if not (err <= ATTN_BOUND and (err <= ATTN_REL_BOUND * top or not kernel)):
            raise AssertionError(f"{label}: error {err} against max {top}")
    return counts


def _unet_forward(pipe, batch: int):
    inputs = paths.unet_inputs(pipe, batch, res=RES)
    with torch.inference_mode():
        return pipe.unet(*inputs)


def phase_nccl_world1(card: str) -> dict:
    """12c: NCCL of world 1; the sharded functions and the tools."""
    import torch.distributed as dist

    from gswm_torch.ops import attention as attn
    from gswm_torch.ops import groupnorm as gn
    from gswm_torch.ops.ring_attention import ring_attention
    from gswm_torch.sharding import gather_batch, make_mesh, shard_batch, shard_params
    from gswm_torch.tools import dryrun_multichip, run_config5_artifact

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh()
        g = torch.Generator(device="cuda").manual_seed(1214)
        b, s, h, d = paths.LSE_SHAPES[1]
        q, k, v = (torch.randn((b, s, h, d), generator=g, device="cuda").bfloat16()
                   for _ in range(3))
        x = torch.randn((2, 320, 64, 64), generator=g, device="cuda").bfloat16()
        w = 1 + 0.05 * torch.randn(320, generator=g, device="cuda")
        bias = 0.05 * torch.randn(320, generator=g, device="cuda")
        pipe = paths.build_pipeline("sd-2-1-base")
        _reset_counters()
        single = attn.flash_attention_split(q, k, v)
        checks = {
            "flash_attention_sharded": torch.equal(
                attn.flash_attention_sharded(q, k, v, mesh), single),
            "ring_attention": torch.equal(ring_attention(q, k, v, mesh), single),
            "fused_group_norm_sharded": torch.equal(
                gn.fused_group_norm_sharded(x, w, bias, mesh, groups=32, eps=1e-5, act="silu"),
                gn.fused_group_norm(x, w, bias, 32, 1e-5, "silu")),
            "shard_batch/gather_batch": torch.equal(gather_batch(shard_batch(x, mesh), mesh), x),
        }
        want = _unet_forward(pipe, paths.MULTIDEVICE_UNET_BATCH)
        shard_params(pipe.unet, mesh)
        checks["shard_params UNet"] = torch.equal(
            _unet_forward(pipe, paths.MULTIDEVICE_UNET_BATCH), want)
        del pipe
        torch.cuda.empty_cache()
        counts = _counters()
        print(f"12c NCCL world 1 ({dist.get_backend()}), mesh {mesh}: equal to the "
              f"single-device calls bit for bit: {checks}; launches "
              f"{({k: n for k, n in counts.items() if n})}", flush=True)
        if not all(checks.values()):
            raise AssertionError(f"12c: sharded calls differ from single-device ones {checks}")
        t0 = time.perf_counter()
        dryrun = dryrun_multichip.main(["--device", "cuda"])[0]
        print(f"12c dryrun_multichip at world 1: {dryrun}; {time.perf_counter() - t0:.2f} s",
              flush=True)
        before = _counters()
        t0 = time.perf_counter()
        c5 = run_config5_artifact.main(["--n", "10000", "--device", "cuda"])[0]
        total = _counters()
        c5_counts = {name: total[name] - before[name] for name in total}
        by_phase = {r["phase"]: r for r in c5}
        print(f"12c run_config5_artifact --n 10000 at world 1: "
              f"{by_phase['decode_dp_sharded']['exact_decodes']} of 10000 exact, "
              f"{by_phase['trace_native']['correct_attributions']} of 16 attributed, "
              f"{by_phase['trace_native']['candidates_per_sec']:.1f} candidates/s on the "
              f"host library; {time.perf_counter() - t0:.2f} s; launches "
              f"{({k: n for k, n in c5_counts.items() if n})}", flush=True)
        if by_phase["decode_dp_sharded"]["exact_decodes"] != 10000 or \
                by_phase["trace_native"]["correct_attributions"] != 16 or \
                not by_phase["trace_device"]["correct"]:
            raise AssertionError(f"12c config-5 run: {c5}")
    finally:
        dist.destroy_process_group()
    return total


def _phase12d_rank() -> dict:
    """One of the two ranks of 12d on the one card (gloo): the dp = 2
    extraction, then the tp = 2 UNet forward.  Rank 0 also runs the
    one-process versions."""
    import torch.distributed as dist

    from gswm_torch import recover_message_bits
    from gswm_torch.models.layers import Attention
    from gswm_torch.ops import attention as attn
    from gswm_torch.sharding import gather_batch, make_mesh, shard_batch, shard_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    pipe = paths.build_pipeline("sd-2-1-base")
    cfg = paths.config(RES, "gswm_torch phase 12d")
    zt, msg = paths.embed(cfg, paths.MULTIDEVICE_DP_BATCH, paths.MULTIDEVICE_SEED)
    out = {"rank": rank}

    def extract(z):
        x0 = pipe.generate(z, guidance_scale=1.0, num_steps=STEPS, decode=False)
        return pipe.extract_bits(cfg, latents=x0, num_steps=STEPS)

    mesh = make_mesh(dp=2, tp=1, device_type="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bits, z = extract(shard_batch(zt, mesh))
    torch.cuda.synchronize()
    out["dp_rank_s"] = time.perf_counter() - t0
    # gloo's all_gather is asked for on the host: the tensors are moved here
    bits, z = gather_batch(bits.cpu(), mesh), gather_batch(z.cpu(), mesh)
    if rank == 0:
        bits_1, z_1 = extract(zt)
        out.update(dp_bits_equal=torch.equal(bits, bits_1.cpu()),
                   dp_max_dz=(z - z_1.cpu()).abs().max().item(),
                   dp_bit_accuracy=_bit_accuracy(recover_message_bits(z_1, cfg), msg, "cuda"))

    batch = paths.MULTIDEVICE_UNET_BATCH
    if rank == 0:
        default = _unet_forward(pipe, batch)
        for m in pipe.unet.modules():  # the routes a tp mesh gives (split, plain)
            if isinstance(m, Attention):
                m.sharded = True
        want = _unet_forward(pipe, batch)
    tp_mesh = make_mesh(dp=1, tp=2, device_type="cuda")
    shard_params(pipe.unet, tp_mesh)
    before = {name: getattr(attn, name).launches for name in ATTENTION_COUNTERS}
    by_d = dict(attn.flash_attention_split.launches_by_d)
    got = _unet_forward(pipe, batch)
    torch.cuda.synchronize()
    out["k4_by_d"] = {dd: n - by_d.get(dd, 0)
                      for dd, n in attn.flash_attention_split.launches_by_d.items()
                      if n - by_d.get(dd, 0)}
    out["attention_launches"] = {name: getattr(attn, name).launches - before[name]
                                 for name in ATTENTION_COUNTERS}
    out["sharded_attention"] = sum(m.tp_group is not None for m in pipe.unet.modules()
                                   if isinstance(m, Attention))
    if rank == 0:
        top = want.abs().max().item()
        out.update(tp_err=(got - want).abs().max().item(), tp_top=top,
                   tp_vs_default=(got - default).abs().max().item() / default.abs().max().item(),
                   finite=bool(torch.isfinite(got).all()))
    return out


def phase_two_ranks(card: str) -> dict:
    """12d: two ranks on the one card over gloo."""
    from gswm_torch.sharding.launch import spawn

    t0 = time.perf_counter()
    ranks = spawn(_phase12d_rank, 2, device_type="cuda", backend="gloo")
    r0 = ranks[0]
    print(f"12d two ranks on {card} over gloo: {time.perf_counter() - t0:.2f} s", flush=True)
    print(f"   dp = 2, {paths.MULTIDEVICE_DP_BATCH} watermarked latents of sd-2-1-base at "
          f"{RES}x{RES}, {STEPS} + {STEPS} steps: voted bits equal to one process "
          f"{r0['dp_bits_equal']}, max |dz_T| {r0['dp_max_dz']:.3e}, bit accuracy "
          f"{r0['dp_bit_accuracy']}; a rank's extraction {[r['dp_rank_s'] for r in ranks]} s",
          flush=True)
    print(f"   tp = 2, sd-2-1-base UNet forward at {RES}x{RES}, batch "
          f"{paths.MULTIDEVICE_UNET_BATCH}, bf16: max|tp - one process| {r0['tp_err']:.5f}, "
          f"relative {r0['tp_err'] / r0['tp_top']:.5f} (bound {TP_REL_BOUND}; one-process "
          f"forward on the split and plain routes), against the default route "
          f"{r0['tp_vs_default']:.5f}; sharded attention layers "
          f"{[r['sharded_attention'] for r in ranks]}; K4 launches by head dim "
          f"{[r['k4_by_d'] for r in ranks]}; attention launches "
          f"{[r['attention_launches'] for r in ranks]}", flush=True)
    if not r0["dp_bits_equal"]:
        raise AssertionError("12d: the dp = 2 extraction's bits differ from one process's")
    if r0["tp_err"] > TP_REL_BOUND * r0["tp_top"] or not r0["finite"]:
        raise AssertionError(f"12d: the tp = 2 forward is {r0['tp_err']} off, max {r0['tp_top']}")
    # level 0: 2 down + 3 up self-attentions of 4096 tokens (5 heads, kept
    # whole), level 1: 5 of 1024 (10 heads, 5 a rank), each the split kernel
    # at d = 64 (GSWM_FLASH_MIN_SEQ 1024); level 2 and the mid block plain
    for r in ranks:
        others = {k: n for k, n in r["attention_launches"].items()
                  if k != "flash_attention_split" and n}
        if r["k4_by_d"] != {64: 10} or others or r["sharded_attention"] != 2 * (5 + 1 + 5):
            raise AssertionError(f"12d rank {r['rank']}: K4 {r['k4_by_d']}, other attention "
                                 f"{others}, sharded layers {r['sharded_attention']}")
    return r0


def phase_hostlib(card: str) -> dict:
    """12e: the native host library against its plain versions."""
    import shutil

    from gswm_torch import hostlib
    from gswm_torch.core import bits as bitops
    from gswm_torch.core import chacha
    from gswm_torch.core.decode import quantize_latent_bits
    from gswm_torch.core.multikey import recover_message_bits_multikey
    from gswm_torch.eval import trace

    scratch = os.path.join("build", "gswm_torch_host_check")
    shutil.rmtree(scratch, ignore_errors=True)
    _, build_s = hostlib.build(hostlib.SOURCE, scratch)
    shutil.rmtree(scratch, ignore_errors=True)
    n = paths.MULTIKEY_RECORDS
    m = HOST_PLAIN_SLICE
    cfg = paths.multikey_config()
    keys, nonces, messages, records = paths.multikey_material()
    lat = paths.multikey_embed_all(cfg, keys, nonces, messages)
    host = lat.cpu().numpy().reshape(n, -1)
    device_q = quantize_latent_bits(lat, 1).cpu().numpy()
    qbits = np.stack([hostlib.quantize_bits(row) for row in host])
    if not np.array_equal(qbits, device_q):
        raise AssertionError("hostlib.quantize_bits differs from the card's quantization")
    for i in range(m):
        if not np.array_equal(qbits[i], trace.quantize_bits_host(host[i])):
            raise AssertionError(f"hostlib.quantize_bits differs from numpy at record {i}")
    n_bits = qbits.shape[1]
    ks_bits = chacha.batch_keystream_bits(keys, nonces, n_bits, "cuda").cpu().numpy()
    device_votes = recover_message_bits_multikey(lat, cfg, keys, nonces).cpu().numpy()
    want = np.unpackbits(np.frombuffer(b"".join(messages), np.uint8)).reshape(n, 256)
    for i in range(n):
        ks = hostlib.chacha20_keystream(keys[i], nonces[i], n_bits // 8)
        if not np.array_equal(np.unpackbits(np.frombuffer(ks, np.uint8)), ks_bits[i]):
            raise AssertionError(f"hostlib keystream differs from the card's at record {i}")
        voted = hostlib.decode(qbits[i], keys[i], nonces[i], 256)
        if not np.array_equal(voted, device_votes[i]) or \
                hostlib.match_accuracy(voted, want[i]) != trace.match_accuracy(voted, want[i]):
            raise AssertionError(f"hostlib decode or match count differs at record {i}")
        if i < m and (ks != chacha.keystream_bytes_host(keys[i], nonces[i], n_bits // 8) or
                      not np.array_equal(voted, trace.decode_host(qbits[i], keys[i],
                                                                  nonces[i], 256))):
            raise AssertionError(f"hostlib keystream or decode differs from numpy at {i}")

    def numpy_loop(latent, cands):
        q = trace.quantize_bits_host(latent)
        return [trace.match_accuracy(trace.decode_host(
            q, bytes.fromhex(r["key_hex"]), bytes.fromhex(r["nonce_hex"]), 256),
            bitops.hex_to_bits(r["message_hex"])[:256]) for r in cands]

    probes = (7, 4242)
    t0 = time.perf_counter()
    found = [trace.find_source(host[i], records) for i in probes]
    lib_rate = len(probes) * n / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    plain = numpy_loop(host[probes[0]], records[:m])
    plain_rate = m / (time.perf_counter() - t0)
    if [f[:2] for f in found] != [(i, 1.0) for i in probes] or plain != found[0][2][:m]:
        raise AssertionError(f"find_source on the library: {[f[:2] for f in found]}")
    print(f"12e host library: build {build_s:.2f} s (g++ -O3, {hostlib.library().path.name}); "
          f"quantize ({n} latents), keystream, decode and match count bit-exact over the "
          f"{n}-record registry against the card, and against numpy on {m} records; "
          f"find_source {lib_rate:.1f} candidates/s on the library ({len(probes)} probes x "
          f"{n}) against {plain_rate:.1f} for the numpy loop ({m} records), "
          f"{lib_rate / plain_rate:.1f}x; on {card}", flush=True)
    return dict(build_s=build_s, lib_rate=lib_rate, plain_rate=plain_rate)


def phase_multidevice(card: str, records: dict) -> dict:
    """Phase 12; returns the launch counts of its paths (12b, 12c)."""
    t0 = time.perf_counter()
    print("12. multi-device on one card", flush=True)
    phase_lse(card, records)
    counts = phase_ring_one_card(card)
    counts_c = phase_nccl_world1(card)
    phase_two_ranks(card)
    phase_hostlib(card)
    print(f"phase 12: {time.perf_counter() - t0:.2f} s", flush=True)
    return {name: counts[name] + counts_c[name] for name in counts}


def main() -> None:
    card = phase_card()
    phase_build()
    pipe_768 = build_pipeline_768()
    records = phase_kernels(paths.groupnorm_cases(pipe_768))
    counts_512, pipe_512, rate_3b = phase_extraction_512(card)
    t_new = time.perf_counter()
    counts_new = [phase_memory_sweep(card, pipe_512, "sd-2-1-base", check_steps=STEPS)]
    seconds_new = time.perf_counter() - t_new
    counts_768 = phase_generation_768(card, pipe_768)
    t_new = time.perf_counter()
    counts_new.append(phase_memory_sweep(card, pipe_768, "sd-2-1"))
    seconds_new += time.perf_counter() - t_new
    counts_tiers = phase_tiers(card, pipe_768)
    counts_gn = phase_groupnorm_op(pipe_768)
    counts_mk = phase_multikey(card, pipe_512)
    t_new = time.perf_counter()
    print("11. the host surfaces and the lossless check, sd-2-1-base at 512x512", flush=True)
    counts_quality, _ = phase_quality(card, pipe_512)
    counts_new += [counts_quality, phase_integrations(card, pipe_512)]
    seconds_new += time.perf_counter() - t_new
    del pipe_512
    torch.cuda.empty_cache()
    fitted, counts_fit = phase_fit(card)
    counts_cli = phase_cli(card, fitted, rate_3b)
    pipe_768.vae.load_state_dict(fitted)
    pipe_768.weights_loaded_()
    counts_bench = phase_bench(card, pipe_768)
    del pipe_768
    torch.cuda.empty_cache()
    counts_sdxl, seconds = phase_sdxl(card)
    seconds_new += seconds
    torch.cuda.empty_cache()
    counts_sd14 = phase_sd14(card, rate_3b)
    t_new = time.perf_counter()
    counts_new.append(phase_suggested_batch(card))
    seconds_new += time.perf_counter() - t_new
    print(f"the memory sweeps, the suggested batch and phase 11: {seconds_new:.2f} s",
          flush=True)
    counts_12 = phase_multidevice(card, records)
    counts = {name: counts_512[name] + counts_768[name] + counts_tiers[name]
              + counts_gn[name] + counts_mk[name] + counts_fit[name] + counts_cli[name]
              + counts_bench[name]
              + counts_sdxl[name] + counts_sd14[name] + counts_12[name]
              + sum(c[name] for c in counts_new) for name in counts_512}
    # the split wrapper's count, less what flash_hopper.cu ran of it
    counts["flash_attention_split"] -= counts["flash_attention_split_d64"]
    sources = {
        "chacha20": ("gswm_torch/csrc/chacha20.cu",
                     "gswm/core/chacha.py:158"),
        # the JAX package's many-key keystream is plain XLA over the same
        # block function (gswm/core/multikey.py:29); the port gives it to K3
        "chacha20_batch": ("gswm_torch/csrc/chacha20.cu",
                           "gswm/core/chacha.py:158"),
        "fused_qkv_attention": ("gswm_torch/csrc/fused_qkv.cu",
                                "gswm/ops/attention.py:689"),
        "flash_attention": ("gswm_torch/csrc/flash_hopper.cu",
                            "gswm/ops/attention.py:1211"),
        "flash_attention_split": ("gswm_torch/csrc/flash_split.cu",
                                  "gswm/ops/attention.py:414"),
        "flash_attention_split_d64": ("gswm_torch/csrc/flash_hopper.cu",
                                      "gswm/ops/attention.py:414"),
        "flash_attention_packed": ("gswm_torch/csrc/flash_hopper.cu",
                                   "gswm/ops/attention.py:959"),
        "flash_attention_transposed": ("gswm_torch/csrc/flash_transposed.cu",
                                       "gswm/ops/attention.py:1428"),
        "fused_group_norm": ("gswm_torch/csrc/group_norm.cu",
                             "gswm/ops/groupnorm.py:185"),
        # K4 with its log-sum-exp output: the ring's per-step kernel, where
        # the JAX package's ring runs plain XLA (ring_attention.py:39); its
        # no-mesh fallback reaches the Pallas K4
        "flash_attention_split_lse_d64": ("gswm_torch/csrc/flash_hopper.cu",
                                          "gswm/ops/attention.py:414"),
        "flash_attention_split_lse": ("gswm_torch/csrc/flash_split.cu",
                                      "gswm/ops/attention.py:414"),
    }
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=counts[name], **records[name])
               for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
