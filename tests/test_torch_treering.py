"""PyTorch port vs the JAX package: the Tree-Ring toolkit.

The same latents and the same normal ``base`` (drawn by jax, fed to the port)
through ``gswm.treering.core`` and ``gswm_torch.treering.core`` on the CPU.
Tolerances: FFT values (the pattern, the injected latents, the distances)
within 1e-4 of the largest magnitude (float32 FFTs of 32 x 32 to 64 x 64 sum
in different orders in the two libraries; measured <= 2e-7), p-values within
1e-6; the masks are equal.  ``compat``'s helpers take and return PIL images and
are held exactly.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gswm.treering import compat as j_compat
from gswm.treering import core as j_core
from gswm_torch import treering
from gswm_torch.treering import compat, core

REL = 1e-4
SHAPE = (2, 4, 64, 64)


def close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("shape,channel,radius,kind", [
    (SHAPE, 0, 10, "circle"), (SHAPE, -1, 10, "circle"), ((1, 4, 32, 32), 3, 4, "square"),
    ((1, 4, 32, 32), 0, 4, "no"), ((3, 4, 96, 96), 1, 16, "circle")])
def test_mask_equals_reference(shape, channel, radius, kind):
    got = core.get_watermarking_mask(shape, channel, radius, kind, device="cpu")
    want = np.asarray(j_core.get_watermarking_mask(shape, channel, radius, kind))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_mask_shapes():
    shape = (1, 4, 32, 32)
    circle = core.get_watermarking_mask(shape, 0, 8, "circle", device="cpu")
    assert bool(circle[0, 0, 16, 16]) and not bool(circle[0, 1, 16, 16])
    allch = core.get_watermarking_mask(shape, -1, 8, "circle", device="cpu")
    assert bool(allch[0, 3, 16, 16])
    square = core.get_watermarking_mask(shape, 0, 4, "square", device="cpu")
    assert int(square[0, 0].sum()) == 64
    with pytest.raises(ValueError):
        core.get_watermarking_mask(shape, 0, 4, "star", device="cpu")


@pytest.mark.parametrize("kind", ["ring", "seed_ring", "rand", "zeros", "const"])
def test_pattern_matches_reference(kind):
    key = jax.random.key(1)
    base = np.array(jax.random.normal(key, SHAPE))
    want = np.asarray(j_core.get_watermarking_pattern(key, SHAPE, kind, 10))
    got = core.get_watermarking_pattern(SHAPE, kind, 10, base=base, device="cpu")
    assert got.dtype == torch.complex64
    close(got.numpy(), want)


def test_pattern_from_a_generator_and_unknown_kind():
    a = core.get_watermarking_pattern(SHAPE, "ring", 10, device="cpu",
                                      generator=torch.Generator().manual_seed(3))
    b = core.get_watermarking_pattern(SHAPE, "ring", 10, device="cpu",
                                      generator=torch.Generator().manual_seed(3))
    c = core.get_watermarking_pattern(SHAPE, "ring", 10, device="cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    # a ring is constant along its radius
    assert a[0, 0, 32, 32 - 5] == a[0, 0, 32 + 5, 32] == a[0, 0, 32 - 3, 32 - 4]
    with pytest.raises(ValueError):
        core.get_watermarking_pattern(SHAPE, "star", device="cpu")


@pytest.fixture(scope="module")
def marked():
    lat = np.array(jax.random.normal(jax.random.key(0), SHAPE))
    key = jax.random.key(1)
    jmask = j_core.get_watermarking_mask(SHAPE, 0, 10)
    jpattern = j_core.get_watermarking_pattern(key, SHAPE, "ring", 10)
    mask = core.get_watermarking_mask(SHAPE, 0, 10, device="cpu")
    pattern = core.get_watermarking_pattern(
        SHAPE, "ring", 10, base=np.array(jax.random.normal(key, SHAPE)), device="cpu")
    jwm = j_core.inject_watermark(jnp.asarray(lat), jmask, jpattern)
    wm = core.inject_watermark(torch.from_numpy(lat), mask, pattern)
    return lat, (jmask, jpattern, jwm), (mask, pattern, wm)


def test_inject_matches_reference(marked):
    lat, (_, _, jwm), (_, _, wm) = marked
    assert wm.dtype == torch.float32 and tuple(wm.shape) == SHAPE
    close(wm.numpy(), np.asarray(jwm))
    assert not np.allclose(wm.numpy(), lat, atol=1e-2)


def test_eval_and_p_value_match_reference(marked):
    lat, (jmask, jpattern, jwm), (mask, pattern, wm) = marked
    for x, jx in ((wm, jwm), (torch.from_numpy(lat), jnp.asarray(lat))):
        close(core.eval_watermark(x, pattern, mask).numpy(),
              np.asarray(j_core.eval_watermark(jx, jpattern, jmask)))
        got = core.get_p_value(x, pattern, mask)
        want = j_core.get_p_value(jx, jpattern, jmask)
        assert len(got) == 2 and all(isinstance(p, float) for p in got)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_inject_detect(marked):
    """tests/test_native_trace_treering.py::test_treering_inject_detect on
    the port."""
    lat, _, (mask, pattern, wm) = marked
    clean = torch.from_numpy(lat)
    d_wm = treering.eval_watermark(wm, pattern, mask)
    d_clean = treering.eval_watermark(clean, pattern, mask)
    assert float(d_wm.mean()) < float(d_clean.mean()) * 0.5
    assert max(treering.get_p_value(wm, pattern, mask)) < \
        min(treering.get_p_value(clean, pattern, mask))


# -- compat ----------------------------------------------------------------------


def test_transform_img_equals_reference():
    rng = np.random.default_rng(0)
    img = Image.fromarray((rng.uniform(size=(100, 160, 3)) * 255).astype(np.uint8))
    out = compat.transform_img(img, 64)
    assert out.shape == (3, 64, 64) and out.dtype == np.float32
    assert out.min() >= -1.0 and out.max() <= 1.0
    np.testing.assert_array_equal(out, j_compat.transform_img(img, 64))


def test_image_distortion_pair_equals_reference():
    rng = np.random.default_rng(0)
    img1 = Image.fromarray((rng.uniform(size=(32, 32, 3)) * 255).astype(np.uint8))
    img2 = Image.fromarray((rng.uniform(size=(32, 32, 3)) * 255).astype(np.uint8))
    args = argparse.Namespace(r_degree=15, jpeg_ratio=50, crop_scale=0.8,
                              gaussian_blur_r=1, gaussian_std=0.1,
                              brightness_factor=2, distortion_seed=1)
    got = compat.image_distortion(img1, img2, args)
    want = j_compat.image_distortion(img1, img2, args)
    for g, w, src in zip(got, want, (img1, img2)):
        assert g.size == (32, 32)
        assert g.convert("RGB").tobytes() == w.convert("RGB").tobytes()
        assert not np.array_equal(np.asarray(g.convert("RGB")), np.asarray(src))
    same = compat.image_distortion(img1, img2, argparse.Namespace())
    assert same[0] is img1 and same[1] is img2


def test_compat_reexports_the_seed_helper():
    compat.set_random_seed(4)
    a = np.random.rand()
    j_compat.set_random_seed(4)
    assert a == np.random.rand()
