"""The launches ``gswm_torch/tools/paths.py`` predicts for a UNet forward from
the attention route of each of its sites, against the counts
``chip_smoke.py`` holds its forwards to; the K7 shapes of users'
resolutions; and the UNet inputs at a size of its own."""

import pytest
import torch

from gswm_torch.ops import attention as attn
from gswm_torch.tools import paths

ROWS = attn.ROWS_FORM

# (preset, height, width, switch set, launches by wrapper and head dim, K7's
# launches by kernel): phase 10's forwards at 512x512 and 576x576 and phase
# 9's at 1024x1024 and 832x1216, on the default route and under phase 10's
# set (t); phase 5's 768x768 forward under (c) and (e)
FORWARDS = [
    ("sd-1-4", 512, 512, {}, {"flash_attention": {40: 5},
                              "fused_qkv_attention": {80: 5, 160: 5}}, {}),
    ("sd-1-4", 512, 512, paths.SD14_SWITCHES["t"],
     {"flash_attention_transposed": {40: 5, 80: 5, 160: 5}},
     {"flash_narrow_kernel": 5, "flash_mid_kernel": 10}),
    # 576x576: level 2 holds 18 x 18 = 324 tokens, S % 8 == 4
    ("sd-1-4", 576, 576, {}, {"flash_attention": {40: 5},
                              "fused_qkv_attention": {80: 5, 160: 5}}, {}),
    ("sd-1-4", 576, 576, paths.SD14_SWITCHES["t"],
     {"flash_attention_transposed": {40: 5, 80: 5, 160: 5}},
     {"flash_narrow_kernel": 5, "flash_mid_kernel": 5, "flash_mid_kernel" + ROWS: 5}),
    ("sdxl-base", 1024, 1024, {}, {"flash_attention": {64: 10},
                                   "fused_qkv_attention": {64: 60}}, {}),
    # 832 wide, 1216 high: level 1 holds 52 x 76 = 3952 tokens, level 2 and the
    # mid block 26 x 38 = 988, S % 8 == 4
    ("sdxl-base", *paths.SDXL_BUCKET, {}, {"flash_attention": {64: 10},
                                           "fused_qkv_attention": {64: 60}}, {}),
    ("sdxl-base", *paths.SDXL_BUCKET, paths.SD14_SWITCHES["t"],
     {"flash_attention_transposed": {64: 70}},
     {"flash_transposed_kernel": 10, "flash_transposed_kernel" + ROWS: 60}),
    ("sd-2-1", 768, 768, paths.TIER_SWITCHES["c"],
     {"flash_attention_transposed": {64: 5}, "fused_qkv_attention": {64: 10}},
     {"flash_transposed_kernel": 5}),
    ("sd-2-1", 768, 768, paths.TIER_SWITCHES["e"],
     {"flash_attention": {64: 5}, "flash_attention_split": {64: 5}}, {}),
]


@pytest.mark.parametrize("preset,height,width,switches,by_d,by_kernel", FORWARDS)
def test_launches_predicted_from_the_route(preset, height, width, switches, by_d, by_kernel):
    """What one forward launches, from ``route_self_attention`` at every site:
    the counts phase 10 (sd-1-4 at 512x512 and at 576x576, default route and
    (t)), phase 9 (sdxl-base at 1024x1024 and at its 832x1216 bucket) and
    phase 5 hold the card to; at 576x576 and 832x1216 the level-2 sites
    (S % 8 == 4) take K7's hand-loaded form."""
    assert paths.predicted_launches(preset, height, width, switches) == (by_d, by_kernel)


def test_attention_sites_of_sdxl_at_its_bucket():
    """sdxl-base at 832x1216: no attention at level 0, 10 sites of 10 heads
    of 64 at level 1 (2 down + 3 up transformers of depth 2), 60 of 20 heads
    at level 2 and the mid block (2 + 3 + 1 of depth 10)."""
    sites = paths.attention_sites("sdxl-base", *paths.SDXL_BUCKET)
    assert sorted(set(sites)) == [(988, 64), (3952, 64)]
    assert sites.count((3952, 64)) == 10 and sites.count((988, 64)) == 60
    assert 988 % 8 == 4 and 3952 % 8 == 0


@pytest.mark.parametrize("res,level2", [(512, 256), (576, 324), (704, 484), (832, 676)])
def test_sd14_level2_tokens(res, level2):
    """SD 1.x's level 2 holds (res / 32)^2 tokens: a multiple of 8 at 512x512,
    S % 8 == 4 at the other users' resolutions of the K7 shapes."""
    sites = paths.attention_sites("sd-1-4", res, res)
    assert (level2, 160) in sites and sites.count((level2, 160)) == 5
    assert (level2 % 8 == 0) == (res == 512)


def test_k7_shapes_hold_users_unaligned_level2_sites():
    """paths.K7_SHAPES, which phase 2 and compare_kernels.py run, hold the
    level-2 shapes of users' resolutions where S % 8 == 4 and an odd S at
    every design."""
    for shape in ((8, 324, 8, 160), (8, 484, 8, 160), (8, 324, 20, 64), (2, 988, 20, 64),
                  (1, 1001, 1, 512), (1, 1001, 3, 40), (1, 1001, 3, 64), (1, 1001, 2, 160)):
        assert shape in paths.K7_SHAPES, shape
    designs = {attn.transposed_kernel(d, s) for b, s, h, d in paths.K7_SHAPES if s % 8}
    assert designs == {k + ROWS for k in ("flash_narrow_kernel", "flash_transposed_kernel",
                                          "flash_mid_kernel")} | \
        {"flash_split_kernel" + attn.ALIGNED_FORM}


def test_unet_inputs_take_a_size_of_their_own():
    """``unet_inputs`` at (height, width): latents of (B, 4, height / 8,
    width / 8), and SDXL's time_ids (h, w, 0, 0, h, w) of that size."""
    from gswm_torch.pipelines import InversablePipeline

    pipe = InversablePipeline("tiny-xl", device="cpu", dtype=torch.float32,
                              generator=torch.Generator().manual_seed(0))
    lat, t, ctx, added = paths.unet_inputs(pipe, 2, dev="cpu", size=(96, 64))
    assert tuple(lat.shape) == (2, 4, 12, 8) and tuple(t.shape) == (2,)
    assert added["time_ids"].tolist() == [[96.0, 64.0, 0.0, 0.0, 96.0, 64.0]] * 2
    square = paths.unet_inputs(pipe, 2, dev="cpu", res=64)
    assert tuple(square[0].shape) == (2, 4, 8, 8)
    assert square[3]["time_ids"][0].tolist() == [64.0, 64.0, 0.0, 0.0, 64.0, 64.0]
