"""The work counts behind every kernel's ``bound_ms`` (gswm_torch/roofline.py)
against values worked out by hand, and the rule that the port calls no
library attention: its kernels are its own."""

import re
from pathlib import Path

import pytest

from gswm_torch import roofline

PORT = Path(__file__).resolve().parents[1] / "gswm_torch"


@pytest.mark.parametrize("shape,gflop", [
    ((2, 4096, 4096, 5, 64), 42.9),      # K2, UNet level 0 at 512x512
    ((2, 9216, 9216, 5, 64), 217.4),     # K2 at 768x768
    ((4, 9216, 9216, 5, 64), 434.9),     # K2 under guidance
    ((2, 9216, 9216, 1, 512), 347.9),    # K4, the VAE mid attention
    ((2, 65, 577, 3, 64), 0.0576),       # Sq != Sk
    ((4, 4096, 4096, 8, 40), 85.9),      # K2, SD 1.x level 0, at the true d
])
def test_attention_flops_match_hand_values(shape, gflop):
    flops, _ = roofline.attention_cost(*shape)
    assert flops / 1e9 == pytest.approx(gflop, rel=2e-3)


def test_attention_bytes_read_inputs_once_and_write_the_output_once():
    b, sq, sk, h, d = 2, 300, 1000, 3, 64
    _, nbytes = roofline.attention_cost(b, sq, sk, h, d)
    q = out = b * sq * h * d * 2
    k = v = b * sk * h * d * 2
    assert nbytes == q + k + v + out
    # (2, 9216, 5, 64): four (2, 9216, 320) bf16 arrays
    assert roofline.attention_cost(2, 9216, 9216, 5, 64)[1] == 4 * 2 * 9216 * 320 * 2


@pytest.mark.parametrize("b,s,c,h,gflop", [
    (4, 2304, 640, 10, 22.6), (2, 2304, 640, 10, 11.3),
    (2, 1024, 640, 10, 5.03), (2, 256, 1280, 20, 5.03)])
def test_projection_flops_match_hand_values(b, s, c, h, gflop):
    flops, nbytes = roofline.projection_cost(b * s, c, h * 64)
    assert flops / 1e9 == pytest.approx(gflop, rel=3e-3)
    m, n = b * s, h * 64
    assert nbytes == 2 * (m * c + 3 * n * c + 3 * m * n)


@pytest.mark.parametrize("b,s,c,h,d", [(4, 2304, 640, 10, 64), (4, 1024, 640, 8, 80),
                                     (4, 256, 1280, 8, 160)])
def test_fused_qkv_cost_is_projection_plus_attention_without_qkv_traffic(b, s, c, h, d):
    """At the true head dim: SD 1.x's 80 and 160 count no padded columns."""
    flops, nbytes = roofline.fused_qkv_cost(b, s, c, h, d)
    assert flops == roofline.projection_cost(b * s, c, h * d)[0] + \
        roofline.attention_cost(b, s, s, h, d)[0]
    assert nbytes == 2 * (b * s * c + 3 * h * d * c + b * s * h * d)


@pytest.mark.parametrize("shape,ms", [
    ((2, 4096, 4096, 5, 64), 0.0434), ((2, 9216, 9216, 5, 64), 0.2198),
    ((4, 9216, 9216, 5, 64), 0.4397), ((2, 9216, 9216, 1, 512), 0.352),
    ((4, 4096, 4096, 8, 40), 0.0869)])
def test_attention_bound_is_the_tensor_core_time(shape, ms):
    bound, by = roofline.bound_ms(*roofline.attention_cost(*shape), roofline.PEAK_BF16)
    assert by == "operations"
    assert bound == pytest.approx(ms, rel=2e-3)


def test_bound_takes_the_larger_roof():
    # 1 GFLOP over 1 GB: 1e9 / 989e12 s against 1e9 / 3.35e12 s
    bound, by = roofline.bound_ms(1e9, 1e9, roofline.PEAK_BF16)
    assert by == "bytes" and bound == pytest.approx(1e3 * 1e9 / 3.35e12)
    bound, by = roofline.bound_ms(1e12, 1e6, roofline.PEAK_BF16)
    assert by == "operations" and bound == pytest.approx(1e3 * 1e12 / 989e12)


def test_group_norm_and_chacha_bounds():
    # the largest GroupNorm of the 768x768 path: one read and one write of
    # 75.5 M bf16 values, bound by bytes
    shape = (1, 128, 768, 768)
    ops, nbytes = roofline.group_norm_cost(shape)
    assert nbytes == 2 * 2 * 128 * 768 * 768
    bound, by = roofline.bound_ms(ops, nbytes, roofline.PEAK_FP32)
    assert by == "bytes" and bound == pytest.approx(0.0901, rel=2e-3)
    # 2^20 ChaCha20 blocks: 976 integer operations and 64 bytes a block
    ops, nbytes = roofline.chacha_cost(2**20)
    assert (ops, nbytes) == (2**20 * 976, 2**26)
    assert roofline.bound_ms(ops, nbytes, roofline.PEAK_INT32)[1] == "operations"


def test_chacha_batch_bound_is_the_bits_written():
    """10,000 keystreams of 16,384 bits, a byte a bit: 32 blocks a row of 976
    integer operations each, 163.84 MB of bits and 48 bytes a row of keys:
    0.049 ms of stores against 0.009 ms of integer work."""
    ops, nbytes = roofline.chacha_batch_cost(10000, 16384)
    assert ops == 10000 * 32 * 976
    assert nbytes == 10000 * 16384 + 10000 * 48
    bound, by = roofline.bound_ms(ops, nbytes, roofline.PEAK_INT32)
    assert by == "bytes" and bound == pytest.approx(0.04905, rel=1e-3)
    assert 1e3 * ops / roofline.PEAK_INT32 == pytest.approx(0.0093, rel=1e-2)
    # a ragged length still computes whole blocks
    assert roofline.chacha_batch_cost(3, 700) == (3 * 2 * 976, 3 * 700 + 3 * 48)


@pytest.mark.parametrize("pattern", [
    r"scaled_dot_product_attention", r"torch\.compile", r"cudnn[\w.]*attention",
    r"sdpa_kernel", r"flash_attn"])
def test_port_calls_no_library_attention(pattern):
    """Every attention on the port's path is a kernel of gswm_torch/csrc or
    its plain matmul + softmax version; a library's fused attention or a
    compiled plain version is neither."""
    hits = [f"{path.relative_to(PORT)}:{n}"
            for path in sorted(PORT.rglob("*")) if path.suffix in (".py", ".cu", ".cuh")
            for n, line in enumerate(path.read_text().splitlines(), 1)
            if re.search(pattern, line, re.IGNORECASE)]
    assert not hits, hits


def test_one_head_dim_64_flash_kernel_and_no_switch_picks_another():
    """flash_split.cu instantiates no D = 64 kernel: the split, natural and
    packed layouts reach flash_hopper.cu's launcher at every d <= 64."""
    split = (PORT / "csrc" / "flash_split.cu").read_text()
    assert "launch<64>" not in split
    assert "if (D <= ROW_ELEMS)\n    return gswm_launch_flash_hopper(" in split
    hopper = (PORT / "csrc" / "flash_hopper.cu").read_text()
    assert "wgmma_m64n128k16_ss" in hopper and "tma_load_4d" in hopper
    assert hopper.count('extern "C"') == 1 and "gswm_flash_packed" in hopper
    for src in (PORT / "csrc").glob("*.cu*"):
        assert "getenv" not in src.read_text(), src.name


def _code(name: str) -> str:
    """A CUDA source without its // comments."""
    text = (PORT / "csrc" / name).read_text()
    return "\n".join(line.split("//")[0] for line in text.splitlines())


def test_split_kernel_is_a_wgmma_and_tma_kernel():
    """flash_split.cu (K4 from D = 128 up) runs both products on wgmma (the
    logits from shared memory, p v with p from registers) and moves every tile
    through TMA; it holds no mma.sync, ldmatrix or cp.async code."""
    split = _code("flash_split.cu")
    for used in ("wgmma_m64n64k16_ss<0, 0>", "wgmma_m64n64k16_rs(", "tma_load_4d(",
                 "tma_store_4d(", "mbar_wait(", "reg_inc<", "softmax_tile<"):
        assert used in split, used
    for gone in ("mma_bf16", "mma.sync", "ldmatrix", "cp_async", "cp.async.cg",
                 "__syncthreads();\n    load_tile"):
        assert gone not in split, gone
    for d in (128, 192, 256, 320, 384, 448, 512):  # every width stays instantiated
        assert f"case {d}: return launch<{d}>(" in split


def test_transposed_kernel_keeps_mma_sync_only_for_unaligned_rows():
    """flash_transposed.cu: the wgmma + TMA kernel (both operands of the
    logits MN-major, v K-major) for S % 8 == 0, and one mma.sync kernel, the
    masked one, which the launcher takes only where S % 8 != 0; no cp.async
    code."""
    text = _code("flash_transposed.cu")
    tma, masked = text.split("namespace masked {")
    for used in ("wgmma_m64n64k16_ss<1, 1>", "wgmma_m64n64k16_rs<0>", "tma_load_3d(",
                 "tma_store_3d(", "softmax_tile<"):
        assert used in tma, used
    assert "mma_bf16" not in tma and "ldmatrix" not in tma
    assert "mma_bf16(" in masked and "flash_transposed_masked_kernel" in masked
    assert "cp_async" not in text and "cp.async.cg" not in text
    launcher = masked.split('extern "C"')[1]
    assert "if (S % 8 == 0) return" in launcher
    assert launcher.index("S % 8 == 0") < launcher.index("flash_transposed_masked_kernel")


def test_mma_sync_survives_in_one_kernel_only():
    """mma.sync, ldmatrix and cp.async are gone from csrc/ except in
    flash_transposed.cu's masked kernel; the three flash kernels share one
    softmax (hopper.cuh)."""
    for src in sorted((PORT / "csrc").glob("*.cu*")):
        code = _code(src.name)
        if src.name != "flash_transposed.cu":
            for gone in ("mma.sync", "mma_bf16", "ldmatrix", "cp.async.cg"):
                assert gone not in code, (src.name, gone)
        assert "getenv" not in code, src.name
    for name in ("flash_hopper.cu", "flash_split.cu", "flash_transposed.cu"):
        assert "softmax_tile<" in _code(name), name
    assert _code("hopper.cuh").count("void softmax_tile(") == 1


@pytest.mark.parametrize("pattern", [r"is_available", r"^\s*except\b"])
def test_port_has_no_device_probe_and_no_fallback(pattern):
    """Nothing in gswm_torch/ asks whether there is a card in order to choose
    a device (the tools ask only to refuse to run without one), and no
    wrapper catches a kernel's failure to run its plain version instead.
    ``eval/report.py`` has the one ``except`` outside the tools: it skips a
    line of results.jsonl that an interrupted run tore (JSONDecodeError,
    KeyError), which hides no device and no kernel."""
    allowed = {"tools/compare_kernels.py", "tools/profile_paths.py",
               "eval/report.py"}
    hits = [f"{path.relative_to(PORT)}:{n}"
            for path in sorted(PORT.rglob("*.py"))
            if str(path.relative_to(PORT)) not in allowed
            for n, line in enumerate(path.read_text().splitlines(), 1)
            if re.search(pattern, line)]
    assert not hits, hits
