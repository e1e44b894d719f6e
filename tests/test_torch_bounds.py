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
    flops, _, _ = roofline.attention_cost(*shape)
    assert flops / 1e9 == pytest.approx(gflop, rel=2e-3)


def test_attention_bytes_read_inputs_once_and_write_the_output_once():
    b, sq, sk, h, d = 2, 300, 1000, 3, 64
    _, nbytes, _ = roofline.attention_cost(b, sq, sk, h, d)
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
    flops, nbytes, exps = roofline.fused_qkv_cost(b, s, c, h, d)
    assert flops == roofline.projection_cost(b * s, c, h * d)[0] + \
        roofline.attention_cost(b, s, s, h, d)[0]
    assert nbytes == 2 * (b * s * c + 3 * h * d * c + b * s * h * d)
    assert exps == b * h * s * s  # the attention's, one a logit


@pytest.mark.parametrize("shape,ms", [
    ((2, 4096, 4096, 5, 64), 0.0434), ((2, 9216, 9216, 5, 64), 0.2198),
    ((4, 9216, 9216, 5, 64), 0.4397), ((2, 9216, 9216, 1, 512), 0.352),
    ((4, 4096, 4096, 8, 40), 0.0869)])
def test_attention_bound_is_the_tensor_core_time(shape, ms):
    """The tensor cores' roof alone (FLOP and bytes, no exponentials)."""
    flops, nbytes, _ = roofline.attention_cost(*shape)
    bound, by = roofline.bound_ms(flops, nbytes, roofline.PEAK_BF16)
    assert by == "operations"
    assert bound == pytest.approx(ms, rel=2e-3)


def test_exponential_peak_is_the_sfu_rate():
    """16 ex2 a clock an SM, 132 SMs, at the 1.83 GHz the bf16 peak implies
    (989e12 / (132 x 4096 FLOP a clock))."""
    assert roofline.PEAK_EXP2 == pytest.approx(3.865e12, rel=1e-3)
    assert roofline.PEAK_EXP2 == pytest.approx(16 * roofline.PEAK_BF16 / 4096, rel=2e-3)


@pytest.mark.parametrize("shape,ms,roof", [
    # SD 1.x's level 0: B * H * S^2 = 537 M exponentials take 1.6x the
    # tensor cores' 0.0869 ms
    ((4, 4096, 4096, 8, 40), 0.1389, "exponentials"),
    ((8, 4096, 4096, 8, 40), 0.2778, "exponentials"),
    # d = 64: the two roofs are equal (0.0434 each), the tensor cores by a
    # hair
    ((2, 4096, 4096, 5, 64), 0.0434, "operations"),
    # d = 512: the tensor cores, 8x the exponentials' time
    ((1, 9216, 9216, 1, 512), 0.1759, "operations")])
def test_attention_bound_counts_the_exponentials(shape, ms, roof):
    cost = roofline.attention_cost(*shape)
    b, sq, sk, h, _ = shape
    assert cost[2] == b * h * sq * sk
    bound, by = roofline.attention_bound_ms(cost)
    assert (by, bound) == (roof, pytest.approx(ms, rel=2e-3))
    tensor = roofline.bound_ms(cost[0], cost[1], roofline.PEAK_BF16)[0]
    exps = 1e3 * cost[2] / roofline.PEAK_EXP2
    assert bound == max(tensor, exps)
    if shape[-1] == 64:  # both ways
        assert tensor == pytest.approx(0.0434, rel=2e-3)
        assert exps == pytest.approx(0.0434, rel=2e-3)


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
    # 2^20 ChaCha20 blocks: of 976 integer operations a block the 640 XORs
    # and rotations on the integer ALU, and 64 bytes a block
    ops, nbytes = roofline.chacha_cost(2**20)
    assert (ops, nbytes) == (2**20 * 640, 2**26)
    assert roofline.bound_ms(ops, nbytes, roofline.PEAK_INT32)[1] == "operations"


def test_chacha_batch_bound_is_the_bits_written():
    """10,000 keystreams of 16,384 bits, a byte a bit: 32 blocks a row of 640
    integer operations on the ALU each, 163.84 MB of bits and 48 bytes a row
    of keys: 0.049 ms of stores against 0.012 ms of integer work (64 results
    a clock an SM on compute capability 9.0)."""
    ops, nbytes = roofline.chacha_batch_cost(10000, 16384)
    assert ops == 10000 * 32 * 640
    assert nbytes == 10000 * 16384 + 10000 * 48
    bound, by = roofline.bound_ms(ops, nbytes, roofline.PEAK_INT32)
    assert by == "bytes" and bound == pytest.approx(0.04905, rel=1e-3)
    assert 1e3 * ops / roofline.PEAK_INT32 == pytest.approx(0.01223, rel=1e-2)
    # a ragged length still computes whole blocks
    assert roofline.chacha_batch_cost(3, 700) == (3 * 2 * 640, 3 * 700 + 3 * 48)


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
    """flash_split.cu (K4 from D = 192 up; 64 < D <= 160 goes to
    flash_mid.cu's launcher first) runs both products on wgmma (the logits
    from shared memory, p v with p from registers) and moves every tile
    through TMA (hopper.cuh's tma_load_panel and tma_store_panel, the layout
    a template parameter); it holds no mma.sync, ldmatrix or cp.async
    code."""
    split = _code("flash_split.cu")
    for used in ("wgmma_m64n64k16_ss<0, 0>", "wgmma_m64n64k16_rs(", "tma_load_panel<L>(",
                 "tma_store_panel<LO>(", "mbar_wait(", "reg_inc<", "softmax_tile<"):
        assert used in split, used
    for gone in ("mma_bf16", "mma.sync", "ldmatrix", "cp_async", "cp.async.cg",
                 "__syncthreads();\n    load_tile"):
        assert gone not in split, gone
    for d in (192, 256, 320, 384, 448, 512):  # every width above 160 stays instantiated
        assert f"case {d}: return launch<{d}>(" in split
    assert "case 128:" not in split
    assert split.index("if (D <= MID_MAX_D)\n    return gswm_launch_flash_mid(") < \
        split.index("switch ((D + ROW_ELEMS - 1)")


def test_mid_kernel_overlaps_its_exponentials_and_pads_no_whole_panel():
    """flash_mid.cu (64 < d <= 160): the narrow kernel's loop (tile t + 1's
    logits issued with tile t's p v and retired alone, the exponentials
    between the two waits, rounded into p after the second, consumer
    warpgroups in turns, the row sums on the tensor cores), one warpgroup
    owning a row's every panel (no logits computed twice), ceil(d / 16) k16
    steps of logits and p v at N = 64 on full panels and at the tail's 16,
    32 or 48 on the last; every (full panels, tail) of 72 ... 160 has its
    launch, and nothing in it is mma.sync or cp.async."""
    mid = _code("flash_mid.cu")
    kernel = mid.split("flash_mid_kernel(")[1].split("struct Args")[0]
    for used in ("wgmma_wait<1>()", "named_barrier_arrive(", "wgmma_m64n8k16_rs(l,",
                 "sm.ones", "kk < M::KS", "pv_tail<TAIL, VT>(", "fence_regs(p)",
                 "softmax_exp<", "softmax_pack<", "scale_tile(", "store_lse("):
        assert used in kernel, used
    assert kernel.index("wgmma_wait<1>()") < kernel.index("softmax_exp<BN / 8>(s, m_lo, m_hi, "
                                                         "a_lo, a_hi, Sk - (t + 1)")
    assert "softmax_tile<" not in kernel and "CONSUMERS" not in kernel
    for n in (16, 32):
        assert f"wgmma_m64n{n}k16_rs<TRANS_B>(o, a, dv)" in mid
    for full, tail in ((1, 16), (1, 32), (1, 48), (2, 0), (2, 16), (2, 32)):
        assert f"case {100 * full + tail}: return launch<L, {full}, {tail}>(a, wide);" in mid


def test_transposed_kernel_keeps_mma_sync_only_for_unaligned_rows():
    """flash_transposed.cu holds no mma.sync kernel any more: its own d =
    64 design (both operands of the logits MN-major, v K-major) and, above
    d = 160, flash_split.cu's kernel with the layout a template parameter
    (every panel width from 192 instantiated, none at 128, which no d above
    160 rounds to) run wgmma at every S; where S % 8 != 0 the C entry takes
    the same design with its boxes loaded and stored by hand (hopper.cuh
    Layout::rows) or, above 160, over the aligning pre-pass, not another
    kernel.  flash_transposed_split_kernel, the hand-copied split design, is
    gone."""
    text = _code("flash_transposed.cu")
    for gone in ("namespace masked", "mma_bf16", "ldmatrix", "mma.sync",
                 "flash_transposed_masked_kernel", "flash_transposed_split_kernel",
                 "namespace split"):
        assert gone not in text, gone
    for used in ("wgmma_m64n64k16_ss<1, 1>", "wgmma_m64n64k16_rs<0>", "tma_load_4d(",
                 "tma_store_4d(", "softmax_tile<", "align_tokens_kernel",
                 "scale_tile(", "produce_rows<", "store_box_rows("):
        assert used in text, used
    split = _code("flash_split.cu")
    for d in (192, 256, 320, 384, 448, 512):
        assert f"case {d}: return start_transposed<{d}, LO>(" in split
    assert "case 128:" not in split
    for used in ("wgmma_m64n64k16_ss<1, 1>", "wgmma_m64n64k16_rs<0>",
                 "store_tile_out<L>(", "tma_store_panel<LO>(", "tma_load_panel<L>("):
        assert used in split, used
    entry = text.split('extern "C" int gswm_flash_transposed(')[1].split("\n}\n")[0]
    # one launcher, the form chosen by S % 8 alone: no kernel of its own
    assert "launch_design(" in entry and "S % 8 != 0" in entry
    assert "<<<" not in entry and "kernel" not in entry
    rows_entry = text.split('extern "C" int gswm_flash_transposed_rows(')[1].split("\n}\n")[0]
    assert "launch_design(" in rows_entry and ", true," in rows_entry
    design = text.split("cudaError_t launch_design(")[1].split("\n}\n")[0]
    assert "launch_form<true>(" in design and "launch_form<false>(" in design
    form = text.split("cudaError_t launch_form(")[1].split("\n}\n")[0]
    assert "ROWS ? launch_split_aligned(" in form


# the hand-loaded form of each transposed design: (source, what instantiates
# it, what its producer and epilogue use)
ROWS_FORMS = {
    "narrow": ("flash_hopper.cu", "launch_narrow_filling<Layout::rows>(",
               ("produce_rows<NWG, BOXES, STAGES>(", "tma_store_panel<L>(",
                "wait_full<ROWS>(")),
    "mid": ("flash_mid.cu", "dispatch<Layout::rows>(",
            ("produce_rows<NQ, NKV, STAGES>(", "tma_store_panel<L>(", "wait_full<ROWS>(")),
    "d64": ("flash_transposed.cu", "launch<2, false, ROWS>(",
            ("produce_rows<NWG, KV_PANELS, STAGES>(", "store_box_rows(sm.q[cw]",
             "wait_full<ROWS>(")),
    # above d = 160 the boxes come by tensor maps over the aligning
    # pre-pass's scratch, and the output goes out by hand
    "split": ("flash_transposed.cu", "launch_split_aligned(",
              ("align_tokens(in, padded,", "gswm_launch_flash_split_transposed(padded, pitch, "
               "out, true,")),
}


@pytest.mark.parametrize("design", sorted(ROWS_FORMS))
def test_every_transposed_design_has_its_hand_loaded_form(design):
    """Each of K7's four designs (flash_hopper.cu's narrow kernel,
    flash_transposed.cu's d = 64 kernel, flash_mid.cu's and flash_split.cu's
    kernels) has its form for S % 8 != 0, which the launcher takes there:
    to d = 160 its boxes loaded and stored by hand (the producer warpgroup
    runs hopper.cuh's produce_rows, the epilogue stores by hand, and the
    consumers wait through wait_full, whose proxy fence makes the copies
    visible to wgmma; in produce_rows a set's copies arrive on the full
    barrier (cp.async.mbarrier.arrive) or, for rows shifted by hand,
    fence_async_smem comes before the thread's arrive); above it the
    aligning pre-pass, the tensor maps over its scratch and the output by
    hand (flash_split.cu's Layout::rows output, hopper.cuh store_box_rows)."""
    src, instance, used = ROWS_FORMS[design]
    code = _code(src)
    assert instance in code, instance
    for u in used:
        assert u in code, u
    if design in ("d64", "split"):
        assert "launch_form<true>(" in code
    if design == "split":
        split = _code("flash_split.cu")
        assert "launch_transposed<Layout::rows>(m_in, BandRows{out, B, S, d}" in split
        assert "store_box_rows(src, *map, h, j * ROW_ELEMS, tok, b)" in _code("hopper.cuh")
    hopper = _code("hopper.cuh")
    place = hopper.split("void rows_place_set(")[1].split("\n}\n")[0]
    assert place.index("fence_async_smem();") < place.index("mbar_arrive(full);")
    copy = hopper.split("void rows_copy_set(")[1].split("\n}\n")[0]
    assert "cp_async_arrive(full)" in copy
    wait = hopper.split("void wait_full(")[1].split("\n}\n")[0]
    assert wait.index("mbar_wait(") < wait.index("fence_async_smem();")
    assert '"cp.async.mbarrier.arrive.noinc.shared::cta.b64' in hopper


def test_hand_loaded_boxes_read_aligned_words_and_store_no_wider_than_pairs():
    """hopper.cuh's hand loads read whole aligned words (16-byte cp.async of
    aligned words, or 8- and 4-byte pieces at even misalignments, which zero-
    fill what lies past S) and shift odd rows by byte permutes; the hand
    store writes 2-byte elements and 4-byte aligned pairs, never a wider
    store and never a read of global memory."""
    hopper = _code("hopper.cuh")
    copy = hopper.split("void rows_copy(")[1].split("\n}\n")[0]
    assert "& ~15ull" in copy and "8 * c - a < n" in copy
    for piece in ("cp_async_16(", "cp_async_8(", "cp_async_4("):
        assert piece in copy, piece
    place = hopper.split("void rows_place(")[1].split("\n}\n")[0]
    assert "__byte_perm(" in place and "__shfl_down_sync(" in place and "__syncwarp(" in place
    store = hopper.split("void store_box_rows(")[1].split("\n}\n")[0]
    assert "uint4*>(out" not in store and "uint2" not in store
    assert "reinterpret_cast<uint32_t*>(out" in store and "out16[" in store
    assert "__ldg" not in store


# the transposed layout's instantiations: (source, the kernel's body from,
# to, the launcher's dispatch, what the transposed branches of the body use)
TRANSPOSED_DESIGNS = {
    "narrow": ("flash_hopper.cu", "flash_narrow_kernel(", "launch_narrow(",
               "launch_narrow_filling<Layout::transposed>(a)",
               ("wgmma_m64n48k16_rs<0>(o, p[kk], dv + (kk / 4) * BOX_DESC + (kk % 4) * "
                "DESC_K_STEP)", "dq + kk * DESC_MN_STEP", "kk < KS")),
    "mid": ("flash_mid.cu", "flash_mid_kernel(", "struct Args",
            "dispatch<Layout::transposed>(",
            ("pv_tail<TAIL, VT>(ot, p[kk], v_step(dv, FULL, kk))",
             "constexpr int VT = T ? 0 : 1;", "wgmma_m64n64k16_rs<VT>(",
             "(kk % 4) * DESC_K_STEP", "dq + (kk / 4) * Q_PANEL_DESC + (kk % 4) * DESC_MN_STEP",
             "kk < M::KS")),
}


@pytest.mark.parametrize("design", sorted(TRANSPOSED_DESIGNS))
def test_transposed_layout_runs_the_natural_layouts_designs(design):
    """K7 at d <= 48 and 64 < d <= 160 (S % 8 == 0) is flash_hopper.cu's
    narrow kernel and flash_mid.cu's kernel with the layout a template
    parameter, one body each: the same overlap (tile t + 1's logits with
    tile t's p v, retired alone by wgmma_wait<1>), the same turns on named
    barriers, the row sums on m64n8k16 and q scaled in shared memory
    (scale_tile), for both layouts; the transposed branches read MN-major q
    and k (one m64n64k16 a 64-token box), K-major v (transpose bit 0, the
    tail's first rows), take boxes by the transposed coordinates, store the
    output transposed, and have no lse; flash_transposed.cu's launcher
    sends those widths there before its own kernels."""
    src, start, end, dispatch, used = TRANSPOSED_DESIGNS[design]
    code = _code(src)
    body = code.split(start)[1].split(end)[0]
    for common in ("template <Layout L,", "wgmma_wait<1>()", "named_barrier(",
                   "named_barrier_arrive(", "wgmma_m64n8k16_rs(l,", "scale_tile(",
                   "softmax_exp<", "softmax_pack<"):
        assert common in code.split(start)[0][-400:] + body, common
    for branch in ("constexpr bool T = L != Layout::natural;", "if constexpr (T)",
                   "wgmma_m64n64k16_ss<1, 1>(", "BOX_DESC",
                   "tma_load_panel<L>(", "tma_store_panel<L>(", "store_tile_out<L>(",
                   "static_assert(L == Layout::natural || !LSE", *used):
        assert branch in body, branch
    assert body.count("wgmma_commit();") == 2  # the logits, and p v: one group each
    assert dispatch in code.split(f"gswm_launch_flash_{design}_transposed(")[1]
    launcher = _code("flash_transposed.cu").split("cudaError_t launch_form(")[1]
    assert launcher.index(f"gswm_launch_flash_{design}_transposed(") < \
        launcher.index("launch<2, false, ROWS>(")
    header = _code("flash_core.cuh")
    assert f"cudaError_t gswm_launch_flash_{design}_transposed(" in header


def test_rs_wrappers_take_the_transpose_bit():
    """hopper.cuh's register-A wgmma wrappers at N = 64, 48, 32 and 16 take
    v's transpose bit as a template argument (1, MN-major, by default), so
    the transposed layout's K-major v reads the first N rows of a panel."""
    code = _code("hopper.cuh")
    for n in (64, 48, 32, 16):
        head = code.split(f"void wgmma_m64n{n}k16_rs(")[0][-80:]
        assert "template <int TRANS_B = 1>" in head, n
    assert code.count('"n"(TRANS_B)') == 5  # the four above and the ss wrapper


def test_narrow_kernel_overlaps_its_exponentials_with_the_tensor_cores():
    """flash_hopper.cu's narrow kernel (d <= 48): tile t + 1's logits issued
    with tile t's p v and retired alone (wgmma_wait<1>), the exponentials
    taken between the two waits and rounded into p after the second, the
    consumer warpgroups taking turns on named barriers, the row sums as p
    times a ones tile on the tensor cores, ceil(d / 16) k16 steps of logits,
    p v at N = 48; the d <= 64 kernel keeps its own loop and softmax, and the
    launcher sends d <= 48 to the narrow one."""
    hopper = _code("flash_hopper.cu")
    narrow = hopper.split("flash_narrow_kernel(")[1].split("launch_narrow(")[0]
    for used in ("wgmma_wait<1>()", "named_barrier_arrive(", "wgmma_m64n48k16_rs(",
                 "wgmma_m64n8k16_rs(l,", "sm.ones", "kk < KS", "fence_regs(p)",
                 "softmax_exp<", "softmax_pack<"):
        assert used in narrow, used
    assert narrow.index("wgmma_wait<1>()") < narrow.index("softmax_exp<BN / 8>(s, m_lo, m_hi, "
                                                         "a_lo, a_hi, Sk - (t + 1)")
    assert "softmax_tile<" not in narrow and "packed_sum" not in narrow
    for ks in (1, 2, 3):
        assert f"launch_narrow<L, NWG, {ks}>(" in hopper
    wide = hopper.split("flash_hopper_kernel(")[1].split("flash_narrow_kernel")[0]
    assert "softmax_tile<BN / 8>(" in wide and "wgmma_wait<1>" not in wide
    launcher = hopper.split("cudaError_t gswm_launch_flash_hopper(")[1]
    assert launcher.index("d <= NARROW_D") < launcher.index("if (d == D)")
    assert "launch_narrow_filling<Layout::natural>(a)" in launcher


def test_mma_sync_survives_in_one_kernel_only():
    """mma.sync and ldmatrix are gone from csrc/, flash_transposed.cu's
    masked kernel with them; cp.async survives in hopper.cuh's hand-loaded
    boxes alone (the transposed layout where S % 8 != 0); the three flash
    kernels share one softmax (hopper.cuh)."""
    for src in sorted((PORT / "csrc").glob("*.cu*")):
        code = _code(src.name)
        for gone in ("mma.sync", "mma_bf16", "ldmatrix"):
            assert gone not in code, (src.name, gone)
        if src.name != "hopper.cuh":  # (cp.async.bulk is TMA's, and stays)
            for gone in ("cp.async.cg", "cp.async.ca", "cp.async.wait"):
                assert gone not in code, (src.name, gone)
        assert "getenv" not in code, src.name
    assert "cp.async.cg.shared.global" in _code("hopper.cuh")
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
