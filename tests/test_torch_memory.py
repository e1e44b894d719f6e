"""The port's batch policy (``gswm_torch.utils.memory``) at the H100's
anchors: the properties tests/test_memory_policy.py holds the JAX package's
to at the v5e's, where they carry over, and ``suggest_weights_dtype``
against the JAX package's rule."""

import math

import jax.numpy as jnp
import pytest
import torch

from gswm.utils.memory import suggest_weights_dtype as jax_suggest_weights_dtype
from gswm_torch.utils import memory
from gswm_torch.utils.memory import suggest_batch

# the card the anchors were measured on (torch.cuda.get_device_properties:
# 79.1787 GiB)
H100 = 79.1787
GiB = 2**30


def _largest_fitting(res, hbm, arch="sd"):
    """The largest batch whose predicted peak fits USABLE_SHARE of ``hbm``,
    by search over the model alone."""
    b = 1
    while memory.predicted_peak_gib(res, b + 1, arch) <= memory.USABLE_SHARE * hbm:
        b += 1
    return b


@pytest.mark.parametrize("res,arch", [(512, "sd"), (768, "sd"), (1024, "sdxl")])
def test_anchors_are_respected(res, arch):
    """At an anchor the suggestion is the largest batch the measured lines
    fit, rounded down to a multiple of 8."""
    b = suggest_batch(res, hbm_gb=H100, arch=arch)
    assert b == _largest_fitting(res, H100, arch) // 8 * 8
    lines = memory.ANCHORS_H100[arch][res]
    assert memory.predicted_peak_gib(res, b, arch) == max(
        fixed + b * per for fixed, per in lines.values())


@pytest.mark.parametrize("res,arch", [(512, "sd"), (640, "sd"), (768, "sd"), (1024, "sd"),
                                      (1024, "sdxl"), (1280, "sdxl")])
def test_never_suggests_past_the_cards_share(res, arch):
    b = suggest_batch(res, hbm_gb=H100, arch=arch)
    assert memory.predicted_peak_gib(res, b, arch) <= 0.9 * H100
    assert memory.predicted_peak_gib(res, b + 8, arch) > memory.USABLE_SHARE * H100


def test_the_inversion_not_the_vae_bounds_the_512_batch():
    """At 512x512 the encode stage's line would allow some 9,000 images;
    the inversion's binds near 1,000."""
    lines = memory.stage_lines(512)
    by_stage = {s: (memory.USABLE_SHARE * H100 - f) / p for s, (f, p) in lines.items()}
    assert by_stage["encode"] > 5000 > 2000 > by_stage["invert"] > 500
    assert suggest_batch(512, hbm_gb=H100) == int(by_stage["invert"]) // 8 * 8


def test_requested_clamps_not_replaces():
    assert suggest_batch(512, hbm_gb=H100, requested=32) == 32
    assert suggest_batch(512, hbm_gb=H100, requested=10**6) == suggest_batch(512, hbm_gb=H100)


def test_scales_with_hbm():
    assert suggest_batch(512, hbm_gb=2 * H100) > suggest_batch(512, hbm_gb=H100)
    assert suggest_batch(512, hbm_gb=H100 / 2) < suggest_batch(512, hbm_gb=H100)


def test_interpolates_between_anchors():
    assert suggest_batch(768, hbm_gb=H100) <= suggest_batch(640, hbm_gb=H100) \
        <= suggest_batch(512, hbm_gb=H100)


def test_interpolation_is_log_linear_between_anchors():
    """Between 512 and 768 each term follows res^p with p from the two
    anchors (the card's per-image bytes grow as about res^2, where the
    reference's v5e batches fell as res^4.4)."""
    a = memory.ANCHORS_H100["sd"]
    p = math.log(a[768]["invert"][1] / a[512]["invert"][1]) / math.log(768 / 512)
    assert 1.8 < p < 2.2
    for res in (576, 640, 704):
        want = a[512]["invert"][1] * (res / 512) ** p
        assert memory.stage_lines(res)["invert"][1] == pytest.approx(want, rel=1e-12)


def test_extrapolation_uses_the_fitted_exponent():
    a = memory.ANCHORS_H100["sd"]
    p = math.log(a[768]["invert"][1] / a[512]["invert"][1]) / math.log(768 / 512)
    assert memory.stage_lines(1024)["invert"][1] == pytest.approx(
        a[768]["invert"][1] * (1024 / 768) ** p, rel=1e-12)
    assert suggest_batch(1024, hbm_gb=H100) < suggest_batch(768, hbm_gb=H100)


def test_tile_aligned_and_positive():
    for res in (256, 512, 640, 768, 1024, 4096):
        b = suggest_batch(res, hbm_gb=H100)
        assert b >= 1 and (b % 8 == 0 or b < 8)
    # a card the encode stage's line overfills still gets a batch of 1
    assert suggest_batch(512, hbm_gb=18.0) == 1
    fixed, per = memory.stage_lines(512)["encode"]  # on 20 GiB the encode stage binds
    assert suggest_batch(512, hbm_gb=20.0) == int((memory.USABLE_SHARE * 20.0 - fixed)
                                                  / per) // 8 * 8


def test_sdxl_family_anchor():
    b = suggest_batch(1024, hbm_gb=H100, arch="sdxl")
    assert suggest_batch(1024, hbm_gb=H100, arch="sdxl", requested=10**4) == b
    # one measured SDXL point: other sizes extrapolate with the sd family's
    # exponents, downwards toward larger images
    assert suggest_batch(1280, hbm_gb=H100, arch="sdxl") <= b


def test_fit_anchor_recovers_a_line():
    assert memory.fit_anchor([32, 64, 128], [3.0 + 0.5 * b for b in (32, 64, 128)]) == \
        pytest.approx((3.0, 0.5))


@pytest.mark.parametrize("gib,hbm", [(3.5, 16.0), (10.3, 16.0), (3.5, 8.0), (6.0, 16.0),
                                     (6.01, 16.0), (29.0, 80.0), (31.0, 80.0),
                                     (10.3, 79.1787)])
def test_weights_dtype_policy_is_the_references(gib, hbm):
    want = jax_suggest_weights_dtype(int(gib * GiB), hbm_gb=hbm)
    got = memory.suggest_weights_dtype(int(gib * GiB), hbm_gb=hbm)
    assert (got is None) == (want is None)
    assert want is None or (want == jnp.bfloat16 and got == torch.bfloat16)


def test_module_and_pipeline_bytes():
    m = torch.nn.Linear(4, 3)
    m.register_buffer("b", torch.zeros(5, dtype=torch.float64))
    assert memory.module_bytes(m, None) == (12 + 3) * 4 + 5 * 8
