"""The benchmark's own arithmetic: the model FLOPs it counts against the
repo's earlier audit, and its copy of the roofline against the port's."""

import json

import pytest

from h100bench import cells, count

AUDIT = json.loads((cells.ROOT / "benchmarks" / "flops_audit.json").read_text())


@pytest.mark.parametrize("name, res, rel", [("sd-2-1-base", 512, 0.025), ("sdxl-base", 1024, 0.005)])
def test_unet_flops_against_the_audit(name, res, rel):
    """GFLOP an image-step: 788.6 (sd-2-1-base, 512x512) and 6,759.3 (sdxl-base,
    1024x1024) in benchmarks/flops_audit.json, XLA's cost analysis of the
    JAX UNet; FlopCounterMode counts 804.3 and 6,761.2, every tap of every
    convolution (those inside the image alone: 782.7 and 6,724.8). XLA counts
    convolutions at the border and elementwise work its own way."""
    want = next(r["gflops_per_img_step_einsum_truth"] for r in AUDIT["rows"]
                if r["preset"] == name and r["res"] == res)
    config = json.loads((cells.HERE / "configs" / f"{name}.json").read_text())
    flops, cores = count.unet_forward(config, 1, res)
    assert abs(flops / 1e9 - want) / want < rel
    assert {c[0] for c in cores} == {"self", "cross"}


@pytest.mark.parametrize("shape", [(2, 4096, 4096, 5, 64), (1, 16384, 16384, 1, 512),
                                   (4, 1024, 1024, 8, 40), (2, 1000, 77, 10, 64)])
def test_roofline_is_the_ports(shape):
    from gswm_torch import roofline

    b, sq, sk, h, d = shape
    assert count.attention_cost(b, sq, sk, h, d) == roofline.attention_cost(b, sq, sk, h, d)
    cost = count.attention_cost(b, sq, sk, h, d)
    assert count.bound_ms(cost[0], cost[1], count.PEAK_BF16, cost[2]) == \
        roofline.attention_bound_ms(cost)
    assert (count.PEAK_BF16, count.PEAK_BYTES, count.PEAK_EXP2) == \
        (roofline.PEAK_BF16, roofline.PEAK_BYTES, roofline.PEAK_EXP2)


def test_request_counts_every_part():
    """A request's FLOPs are its UNet forwards and the rest; guidance doubles
    the UNet's batch; the cores a kernel runs are the UNet's large
    self-attention and the VAE's above 4,096 tokens."""
    config = json.loads((cells.HERE / "configs" / "sdxl-base.json").read_text())
    mix = json.loads((cells.HERE / "traffic" / "generate-1024-b1.json").read_text())
    flops, cores = count.request(config, mix)
    unet, _ = count.unet_forward(config, 2, 1024)
    assert flops > mix["steps"] * unet
    assert any(c[0] == "vae" and c[2] == 16384 for c in cores)
    assert any(c[0] == "text" for c in cores)
