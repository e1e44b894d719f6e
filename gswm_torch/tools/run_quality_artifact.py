"""The "performance-lossless" quality artifact, on the card (the port of
``tools/run_quality_artifact.py``).

The paper's quality claim is that Gaussian-Shading embedding is
distribution-preserving: a watermarked Z_T is exactly N(0,1), so generations
from watermarked and unwatermarked seeds are statistically
indistinguishable — no CLIP model needed for the weight-independent half of
that claim.

Protocol (the reference's): B unwatermarked latents z ~ N(0,1) and B
watermarked latents z = ndtri((u + y)/2^l), from independent
``torch.Generator`` streams of one seed (``numpy.random.SeedSequence(seed)``
spawns three), go through the same ``pipe.generate`` (same step count,
guidance 1.0), and are compared:

  latent-space:  per-population mean/std; two-sample KS on pooled latent
                 values; one-sample KS of the watermarked Z_T against the
                 exact N(0,1) CDF
  pixel-space:   per-population mean/std; two-sample KS on pooled pixels
                 (subsampled); per-image statistic distributions (mean,
                 std, high-frequency energy) compared via two-sample KS;
                 PSNR between the POPULATION MEAN images; each beside the
                 same statistic between the two halves of the unwatermarked
                 population (the control)

Two watermarked populations: ``wm_indep``, each image under its own nonce
(the population marginal is iid N(0,1): the paper's claim, the primary
test), and ``wm_fixed``, one key/nonce/message for the batch (the serving
reality, conditioned on one y draw; recorded with that framing, not as a
failure).

    python -m gswm_torch.tools.run_quality_artifact [--preset sd-2-1-base]
        [--res 512] [--batch 64] [--steps 30] [--device cuda] [--out FILE]

writes build/quality_lossless_<preset>_<res>_torch.jsonl (a meta line, then
the rows under the reference's field names).  Random weights from a seed:
no SD checkpoint is in the repository.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import numpy as np
import torch


def ks_two_sample(a, b):
    """Two-sample KS statistic + asymptotic p-value (scipy-free)."""
    a = np.sort(a.ravel())
    b = np.sort(b.ravel())
    n, m = len(a), len(b)
    both = np.concatenate([a, b])
    cdf_a = np.searchsorted(a, both, side="right") / n
    cdf_b = np.searchsorted(b, both, side="right") / m
    d = float(np.max(np.abs(cdf_a - cdf_b)))
    en = np.sqrt(n * m / (n + m))
    # Kolmogorov asymptotic survival function
    t = (en + 0.12 + 0.11 / en) * d
    p = 2.0 * sum((-1.0) ** (k - 1) * np.exp(-2.0 * (k * t) ** 2)
                  for k in range(1, 101))
    return d, float(min(max(p, 0.0), 1.0))


def ks_normal(a):
    """One-sample KS against the exact N(0,1) CDF."""
    a = np.sort(a.ravel())
    n = len(a)
    cdf = 0.5 * (1.0 + np.vectorize(math.erf)(a / np.sqrt(2.0)))
    d_plus = np.max(np.arange(1, n + 1) / n - cdf)
    d_minus = np.max(cdf - np.arange(0, n) / n)
    d = float(max(d_plus, d_minus))
    en = math.sqrt(n)
    t = (en + 0.12 + 0.11 / en) * d
    p = 2.0 * sum((-1.0) ** (k - 1) * math.exp(-2.0 * (k * t) ** 2)
                  for k in range(1, 101))
    return d, float(min(max(p, 0.0), 1.0))


def hf_energy(imgs):
    """Per-image high-frequency energy: mean squared residual of a 3x3 box
    blur — the band JPEG/blur attacks touch first, and where a
    distribution-shifting embed would most plausibly show."""
    k = np.ones((3, 3), np.float32) / 9.0
    out = []
    for x in imgs:
        acc = 0.0
        for c in range(x.shape[0]):
            p = np.pad(x[c], 1, mode="edge")
            blur = sum(
                p[i:i + x.shape[1], j:j + x.shape[2]] * k[i, j]
                for i in range(3) for j in range(3))
            acc += float(np.mean((x[c] - blur) ** 2))
        out.append(acc / x.shape[0])
    return np.asarray(out)


def artifact_config(pipe, res: int):
    """The reference's watermark configuration at ``res`` for ``pipe``'s VAE
    (256 message bits at the 8x VAE, 32 at the tiny one's)."""
    from gswm_torch import GSConfig

    f = 2 ** (len(pipe.preset.vae.block_out_channels) - 1)
    return GSConfig(key_hex="22" * 32, nonce_hex="33" * 16, message="lthero",
                    width=res, height=res, vae_scale=f,
                    message_bits=256 if f == 8 else 32)


def populations(pipe, res: int, batch: int, seed: int = 2024):
    """(wm_indep, plain, wm_fixed) Z_T of ``batch`` latents each on the
    pipeline's device, from three independent streams of ``seed``."""
    from gswm_torch.core.embed import embed_latents

    cfg = artifact_config(pipe, res)
    dev = pipe.device
    s_wm, s_plain, s_ind = (int(s.generate_state(1, np.uint64)[0] >> np.uint64(1))
                            for s in np.random.SeedSequence(seed).spawn(3))
    zt_fixed, _ = embed_latents(cfg, generator=torch.Generator(device=dev).manual_seed(s_wm),
                                batch=batch, device=dev)
    h, w = cfg.latent_hw
    zt_plain = torch.randn((batch, pipe.preset.vae.latent_channels, h, w),
                           generator=torch.Generator(device=dev).manual_seed(s_plain),
                           device=dev)
    g_ind = torch.Generator(device=dev).manual_seed(s_ind)
    zt_indep = torch.cat([
        embed_latents(dataclasses.replace(cfg, nonce_hex=f"{i + 1:032x}"),
                      generator=g_ind, batch=1, device=dev)[0]
        for i in range(batch)])
    return zt_indep, zt_plain, zt_fixed


def run(pipe, res: int, batch: int, steps: int, pixels_per_image: int = 4096,
        seed: int = 2024, log=print) -> tuple[list[dict], tuple]:
    """The latent and pixel rows of the three populations through ``pipe``
    (the reference's fields, tools/run_quality_artifact.py:176-257); also
    returns the three image batches as numpy float32."""
    zt_indep, zt_plain, zt_fixed = populations(pipe, res, batch, seed)
    b = batch
    rows = []
    pl = zt_plain.double().cpu().numpy().ravel()
    for name, z in (("wm_indep", zt_indep), ("wm_fixed", zt_fixed)):
        wm = z.double().cpu().numpy().ravel()
        d2, p2 = ks_two_sample(wm, pl)
        d1, p1 = ks_normal(wm)
        rows.append({
            "space": "latent", "population": name, "batch": b,
            "elements": int(wm.size),
            "wm_mean": float(wm.mean()), "wm_std": float(wm.std()),
            "plain_mean": float(pl.mean()), "plain_std": float(pl.std()),
            "ks2_stat": d2, "ks2_p": p2,
            "ks1_normal_stat": d1, "ks1_normal_p": p1,
        })
        log(f"latent[{name}]: mean {wm.mean():+.5f} std {wm.std():.5f} | "
            f"vs plain KS D={d2:.5f} p={p2:.3f} | vs N(0,1) KS D={d1:.5f} p={p1:.3f}")

    def generate(z):
        return pipe.generate(z, guidance_scale=1.0, num_steps=steps).float().cpu().numpy()

    imgs_wm, imgs_fx, imgs_pl = generate(zt_indep), generate(zt_fixed), generate(zt_plain)

    # pooled pixel KS on a seeded subsample; the CONTROL for every
    # pixel-space statistic is the same quantity between the two halves of
    # the unwatermarked population (pixels within an image are correlated,
    # so the pooled KS's p-value runs hot even for identical distributions)
    rng = np.random.default_rng(7)
    npx = min(pixels_per_image, imgs_wm[0].size)
    idx = rng.choice(imgs_wm[0].size, size=npx, replace=False)
    half = b // 2

    def pooled(imgs):
        return np.stack([im.ravel()[idx] for im in imgs]).ravel()

    def psnr(a, bb):
        mse = float(np.mean((a - bb) ** 2))
        return 99.0 if mse == 0 else float(10 * np.log10(1.0 / mse))

    sub_pl = pooled(imgs_pl)
    d2c, p2c = ks_two_sample(pooled(imgs_pl[:half]), pooled(imgs_pl[half:]))
    m_pl = imgs_pl.reshape(b, -1).mean(1)
    s_pl = imgs_pl.reshape(b, -1).std(1)
    h_pl = hf_energy(imgs_pl)
    ks_mean_ctrl = ks_two_sample(m_pl[:half], m_pl[half:])
    psnr_ctrl = psnr(imgs_pl[:half].mean(0), imgs_pl[half:].mean(0))

    for name, imgs in (("wm_indep", imgs_wm), ("wm_fixed", imgs_fx)):
        d2p, p2p = ks_two_sample(pooled(imgs), sub_pl)
        m = imgs.reshape(b, -1).mean(1)
        s = imgs.reshape(b, -1).std(1)
        ks_mean = ks_two_sample(m, m_pl)
        ks_std = ks_two_sample(s, s_pl)
        ks_hf = ks_two_sample(hf_energy(imgs), h_pl)
        psnr_pop = psnr(imgs.mean(0), imgs_pl.mean(0))
        rows.append({
            "space": "pixel", "population": name, "batch": b,
            "res": res, "steps": steps,
            "subsampled_pixels": int(sub_pl.size),
            "wm_mean": float(imgs.mean()), "wm_std": float(imgs.std()),
            "plain_mean": float(imgs_pl.mean()),
            "plain_std": float(imgs_pl.std()),
            "ks2_pixels_stat": d2p, "ks2_pixels_p": p2p,
            "ks2_pixels_control_stat": d2c, "ks2_pixels_control_p": p2c,
            "ks2_per_image_mean": {"stat": ks_mean[0], "p": ks_mean[1]},
            "ks2_per_image_mean_control": {"stat": ks_mean_ctrl[0],
                                           "p": ks_mean_ctrl[1]},
            "ks2_per_image_std": {"stat": ks_std[0], "p": ks_std[1]},
            "ks2_per_image_hf_energy": {"stat": ks_hf[0], "p": ks_hf[1]},
            "psnr_population_means_db": psnr_pop,
            "psnr_control_split_db": psnr_ctrl,
        })
        log(f"pixel[{name}]: mean {imgs.mean():+.5f} std {imgs.std():.5f} | plain mean "
            f"{imgs_pl.mean():+.5f} std {imgs_pl.std():.5f}; pooled-pixel KS D={d2p:.5f} "
            f"(control D={d2c:.5f}); per-image KS mean p={ks_mean[1]:.3f} (control "
            f"p={ks_mean_ctrl[1]:.3f}) std p={ks_std[1]:.3f} hf p={ks_hf[1]:.3f}; "
            f"population-mean PSNR {psnr_pop:.2f} dB (control {psnr_ctrl:.2f} dB)")
    return rows, (imgs_wm, imgs_fx, imgs_pl)


def latent_seed_study(pipe, res: int, batch: int, seeds) -> list[dict]:
    """The latent rows' p-values at each seed of ``seeds`` (no generation):
    wm_indep against the plain population and against the exact N(0, 1),
    and the plain population against N(0, 1).  Under the lossless claim
    each is a draw from U(0, 1); one seed's p-value is one draw."""
    out = []
    for seed in seeds:
        zt_indep, zt_plain, _ = populations(pipe, res, batch, seed)
        wm = zt_indep.double().cpu().numpy().ravel()
        pl = zt_plain.double().cpu().numpy().ravel()
        out.append({"seed": seed, "ks2_p": ks_two_sample(wm, pl)[1],
                    "ks1_normal_p": ks_normal(wm)[1], "plain_ks1_normal_p": ks_normal(pl)[1]})
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="sd-2-1-base")
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--pixels-per-image", type=int, default=4096,
                    help="pixel subsample per image for the pooled KS")
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu for the CPU; float32 there, bfloat16 on the card)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--latent-seeds", type=int, default=0,
                    help="also the latent p-values at this many further seeds (no "
                         "generation), printed and kept in the meta line")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from gswm_torch.pipelines import InversablePipeline

    dev = torch.device(args.device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    pipe = InversablePipeline(args.preset, device=dev, dtype=dtype,
                              generator=torch.Generator(device=dev).manual_seed(0))
    out = args.out or os.path.join("build",
                                   f"quality_lossless_{args.preset}_{args.res}_torch.jsonl")
    print(f"generating 3 x {args.batch} images at {args.res}^2, {args.steps} steps ...",
          flush=True)
    t0 = time.time()
    rows, _ = run(pipe, args.res, args.batch, args.steps, args.pixels_per_image,
                  args.seed, log=lambda s: print(s, flush=True))
    print(f"rows in {time.time() - t0:.1f} s", flush=True)
    study = latent_seed_study(pipe, args.res, args.batch,
                              range(args.seed + 1, args.seed + 1 + args.latent_seeds))
    for key in ("ks2_p", "ks1_normal_p", "plain_ks1_normal_p"):
        ps = sorted(r[key] for r in study)
        if ps:
            print(f"latent {key} at {len(ps)} further seeds: below 0.01 {sum(p < 0.01 for p in ps)}, "
                  f"below 0.05 {sum(p < 0.05 for p in ps)}, below 0.5 "
                  f"{sum(p < 0.5 for p in ps)}; sorted {[round(p, 4) for p in ps]}", flush=True)
    meta = {"tool": "gswm_torch/tools/run_quality_artifact.py", "preset": args.preset,
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
            "dtype": str(dtype).replace("torch.", ""),
            "seed_protocol": f"independent torch.Generator streams of seed {args.seed} "
                             "(numpy SeedSequence.spawn)",
            "weights": "random UNet and VAE from seed 0 (no SD checkpoint in the "
                       "repository); the latent rows are weight-independent, the pixel "
                       "rows test the same generate() both ways",
            "latent_seed_study": study}
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as fh:
        fh.write(json.dumps(meta) + "\n")
        for r in rows:
            fh.write(json.dumps(r) + "\n")
    print(f"wrote {out}", flush=True)


if __name__ == "__main__":
    main()
