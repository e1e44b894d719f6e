"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and skips without one.  This file imports
neither jax nor the JAX package, so it runs where jax is not installed; run
it there without the repo's conftest (which configures jax):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Bound: 0.02 absolute between the bf16 kernel and the fp32 plain version at
unit-scale inputs (bf16 rounding of q/k/v, p and the output), and 0.02 of
the largest output entry: over thousands of keys a typical entry is ~0.02,
so the absolute bound alone would pass an error of a few percent.
"""

import math
import time

import pytest
import torch
import torch.nn.functional as F

from gswm_torch.core import chacha
from gswm_torch.distortions import device as attacks
from gswm_torch.distortions import relative_strength_to_absolute
from gswm_torch.models import layers
from gswm_torch.ops import attention as attn
from gswm_torch.ops import groupnorm as gn
from gswm_torch.tools import paths

pytestmark = pytest.mark.gpu
BOUND = 0.02
REL_BOUND = 0.02


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def assert_attention_close(got, want):
    torch.testing.assert_close(got.float(), want, rtol=0, atol=BOUND)
    err = (got.float() - want).abs().max().item()
    assert err <= REL_BOUND * want.abs().max().item()


@pytest.mark.parametrize("n_blocks,counter0", [
    (1, 0), (32, 7), (72, 0), (128, 2**32 - 100), (1000, 2**32 - 3),
    (4099, 2**64 - 2**31)])
def test_keystream_kernel_bit_exact(cuda, n_blocks, counter0):
    key = bytes(range(32))
    nonce = counter0.to_bytes(8, "little") + bytes(range(40, 48))
    before = chacha.keystream_words.launches
    got = chacha.keystream_words(key, nonce, n_blocks, cuda)
    assert chacha.keystream_words.launches == before + 1
    want = chacha.keystream_words_reference(key, nonce, n_blocks, "cpu")
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("b,s,h", [(1, 1, 1), (1, 65, 1), (2, 300, 2),
                                   (2, 256, 20), (1, 2305, 3), (2, 4096, 5),
                                   (2, 9216, 5), (4, 9216, 5), (2, 4096, 10),
                                   (4, 4096, 10)])
def test_flash_kernel_matches_plain(cuda, b, s, h):
    g = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn((b, s, h * 64), generator=g, device=cuda).bfloat16()
               for _ in range(3))
    before = attn.flash_attention.launches
    got = attn.flash_attention(q, k, v, h)
    assert attn.flash_attention.launches == before + 1
    want = attn.flash_attention_reference(q.float(), k.float(), v.float(), h)
    assert_attention_close(got, want)


@pytest.mark.parametrize("b,s,c,h", [(1, 300, 128, 2), (1, 256, 1280, 20),
                                     (2, 1024, 640, 10), (1, 2304, 640, 10),
                                     (4, 2304, 640, 10), (4, 576, 1280, 20),
                                     (2, 1024, 1280, 20), (4, 1024, 1280, 20)])
def test_fused_qkv_kernel_matches_plain(cuda, b, s, c, h):
    g = torch.Generator(device=cuda).manual_seed(s + c)
    x = torch.randn((b, s, c), generator=g, device=cuda).bfloat16()
    ws = [(torch.randn((h * 64, c), generator=g, device=cuda) * c**-0.5).bfloat16()
          for _ in range(3)]
    before = attn.fused_qkv_attention.launches
    got = attn.fused_qkv_attention(x, *ws, h)
    assert attn.fused_qkv_attention.launches == before + 1
    want = attn.fused_qkv_attention_reference(x.float(), *(w.float() for w in ws), h)
    assert_attention_close(got, want)


@pytest.mark.parametrize("sq,sk", [(1, 577), (65, 1000), (300, 577),
                                   (1000, 1000), (9216, 9216)])
@pytest.mark.parametrize("h,d", [(3, 64), (1, 512), (2, 128), (2, 192)])
def test_split_kernel_matches_plain(cuda, sq, sk, h, d):
    """K4 at D = 64, 128 (csrc/flash_mid.cu, two full panels), 192 (an odd
    panel count: flash_split.cu's consumers own 2 + 1) and 512: short query
    lengths, ragged key tails (577 and 1000 keys are not multiples of the
    64-key tile) and the VAE's 9216."""
    assert sk >= attn.SPLIT_MIN_KEYS  # the wrapper's kernel route
    b = 2
    g = torch.Generator(device=cuda).manual_seed(sq + sk + d)
    q = torch.randn((b, sq, h, d), generator=g, device=cuda).bfloat16()
    k, v = (torch.randn((b, sk, h, d), generator=g, device=cuda).bfloat16()
            for _ in range(2))
    before = attn.flash_attention_split.launches
    got = attn.flash_attention_split(q, k, v)
    assert attn.flash_attention_split.launches == before + 1
    want = attn.flash_attention_split_reference(q.float(), k.float(), v.float())
    assert_attention_close(got, want)


def test_flash_kernel_tiles_do_not_cross_the_batch(cuda):
    """1000 tokens are not a multiple of the 128-key tile or the 64-row
    query tile, so the last tile of batch 0 reaches past its end.  With
    batch 1's k and v 100x batch 0's, a tile that read on into batch 1 would
    move batch 0's output by O(1) of its own scale."""
    b, s, h = 2, 1000, 3
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (torch.randn((b, s, h * 64), generator=g, device=cuda) for _ in range(3))
    k[1] *= 100
    v[1] *= 100
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got = attn.flash_attention(q, k, v, h).float()
    want = attn.flash_attention_reference(q.float(), k.float(), v.float(), h)
    assert_attention_close(got[0], want[0])  # batch 0 on its own scale (|out| < 1)
    err = (got[1] - want[1]).abs().max().item()
    assert err <= REL_BOUND * want[1].abs().max().item()


@pytest.mark.parametrize("d", [128, 192, 256, 320, 384, 448, 512])
def test_split_kernel_every_width(cuda, d):
    """K4 at every width flash_split.cu's launcher instantiates, and at 128
    (csrc/flash_mid.cu): the ring is 4 stages deep at D <= 192, 3 at 256, 2
    at 320 and a single k and v buffer from 384 up, and the consumers own
    equal panel counts or one more and one fewer; 700 keys are 11 tiles, so
    every ring wraps, and the last tile is ragged."""
    g = torch.Generator(device=cuda).manual_seed(d)
    q = torch.randn((2, 130, 2, d), generator=g, device=cuda).bfloat16()
    k, v = (torch.randn((2, 700, 2, d), generator=g, device=cuda).bfloat16()
            for _ in range(2))
    got = attn.flash_attention_split(q, k, v)
    want = attn.flash_attention_split_reference(q.float(), k.float(), v.float())
    assert_attention_close(got, want)


@pytest.mark.parametrize("d", [128, 192, 512])
def test_split_kernel_tiles_do_not_cross_the_batch(cuda, d):
    """K4 from D = 128 up: 1000 rows are not a multiple of the 64-row tiles,
    so the last q, k and v tiles of batch 0 reach past its end; with batch
    1's k and v 100x batch 0's, a tile that read on into batch 1 would move
    batch 0's output by O(1) of its own scale.  Batch 1's q is 1/100, so its
    own logits stay O(1): D^-0.5 is no power of two here, the kernel rounds
    the scaled q to bf16 as the TPU kernels do, and logits of O(100) would
    turn that rounding into another argmax than the plain version's."""
    b, s, h = 2, 1000, 2
    g = torch.Generator(device=cuda).manual_seed(d)
    q, k, v = (torch.randn((b, s, h, d), generator=g, device=cuda) for _ in range(3))
    q[1] /= 100
    k[1] *= 100
    v[1] *= 100
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got = attn.flash_attention_split(q, k, v).float()
    want = attn.flash_attention_split_reference(q.float(), k.float(), v.float())
    assert_attention_close(got[0], want[0])  # batch 0 on its own scale (|out| < 1)
    err = (got[1] - want[1]).abs().max().item()
    assert err <= REL_BOUND * want[1].abs().max().item()


@pytest.mark.parametrize("sq,h,d", [(130, 2, 128), (1, 1, 192), (64, 3, 192),
                                    (130, 1, 512)])
def test_split_kernel_masks_ragged_keys(cuda, sq, h, d):
    """K4 from D = 128 up: 577 keys leave one real key in the last 64-key
    tile; the rows TMA zero-fills past Sk must be masked, not attended to
    with logit 0.  v = 1 everywhere makes every output exactly 1 whatever the
    weights, unless zero-filled keys took some."""
    sk = 577
    g = torch.Generator(device=cuda).manual_seed(sq + d)
    q = torch.randn((2, sq, h, d), generator=g, device=cuda).bfloat16()
    k = torch.randn((2, sk, h, d), generator=g, device=cuda).bfloat16()
    ones = attn.flash_attention_split(q, k, torch.ones_like(k)).float()
    torch.testing.assert_close(ones, torch.ones_like(ones), rtol=0, atol=2**-7)


@pytest.mark.parametrize("sq,sk,h", [(130, 577, 5), (1, 577, 1), (64, 577, 2)])
def test_flash_kernel_masks_ragged_keys_at_head_dim_64(cuda, sq, sk, h):
    """Sq != Sk at D = 64: 577 keys leave 65 real keys in the last 128-key
    tile; the rows TMA zero-fills past Sk must be masked, not attended to
    with logit 0.  v = 1 everywhere makes every output exactly 1 whatever the
    weights, unless zero-filled keys took some."""
    g = torch.Generator(device=cuda).manual_seed(sq + sk)
    q = torch.randn((2, sq, h, 64), generator=g, device=cuda).bfloat16()
    k = torch.randn((2, sk, h, 64), generator=g, device=cuda).bfloat16()
    v = torch.randn((2, sk, h, 64), generator=g, device=cuda).bfloat16()
    got = attn.flash_attention_split(q, k, v)
    want = attn.flash_attention_split_reference(q.float(), k.float(), v.float())
    assert_attention_close(got, want)
    ones = attn.flash_attention_split(q, k, torch.ones_like(v)).float()
    torch.testing.assert_close(ones, torch.ones_like(ones), rtol=0, atol=2**-7)


@pytest.mark.parametrize("b,s,h", [
    (2, 256, 20), (1, 1, 1), (1, 65, 1), (1, 8320, 2),
    (2, 8448, 1), (4, 256, 20), (2, 1024, 10),
    # as many 128-row blocks as the card has SMs, and one fewer: the two
    # sides of the launcher's choice on whatever card this is
    (1, "sms", 1), (1, "sms - 1", 1)])
def test_flash_kernel_block_variants(cuda, b, s, h):
    """The launcher takes 128-row blocks unless fewer of them than the card
    has SMs would leave some idle, then 64-row blocks: shapes on both sides
    of that choice (on an H100's 132 SMs the first four take 64-row blocks,
    the next three 128-row ones), each against the plain version."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if isinstance(s, str):
        s = 128 * (sms if s == "sms" else sms - 1)
    g = torch.Generator(device=cuda).manual_seed(b * s + h)
    q, k, v = (torch.randn((b, s, h * 64), generator=g, device=cuda).bfloat16()
               for _ in range(3))
    got = attn.flash_attention(q, k, v, h)
    want = attn.flash_attention_reference(q.float(), k.float(), v.float(), h)
    assert_attention_close(got, want)


@pytest.mark.parametrize("b,s,c,n", [(1, 300, 128, 128), (3, 100, 640, 640),
                                     (1, 1, 64, 64), (2, 1024, 640, 640),
                                     (1, 77, 1280, 320), (4, 576, 1280, 1280)])
def test_projection_gemm_matches_plain(cuda, b, s, c, n):
    """K1's projection GEMM alone against x @ W^T in fp32: ragged M (B * S =
    300 is not a multiple of the 128-row tile), N below and off the 128-column
    tile, and the UNet's shapes.  Outputs are ~N(0, 1): one bf16 rounding
    below 8 is at most 2^-6; the rest is fp32 accumulation order."""
    g = torch.Generator(device=cuda).manual_seed(s + c + n)
    x = torch.randn((b, s, c), generator=g, device=cuda).bfloat16()
    ws = [(torch.randn((n, c), generator=g, device=cuda) * c**-0.5).bfloat16()
          for _ in range(3)]
    before = attn.qkv_projection.launches
    got = attn.qkv_projection(x, *ws)
    assert attn.qkv_projection.launches == before + 1
    for y, w in zip(got, ws):
        want = x.float() @ w.float().t()
        assert y.shape == want.shape and y.dtype == torch.bfloat16
        err = (y.float() - want).abs().max().item()
        assert err <= BOUND and err <= 0.01 * max(want.abs().max().item(), 1.0)
    plain = attn.qkv_projection_reference(x, *ws)
    for y, w in zip(got, plain):  # two bf16 roundings of nearly equal fp32 sums
        torch.testing.assert_close(y.float(), w.float(), rtol=0, atol=2**-5)


def test_split_kernel_takes_different_query_and_key_lengths(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((2, 333, 2, 128), generator=g, device=cuda).bfloat16()
    k, v = (torch.randn((2, 1030, 2, 128), generator=g, device=cuda).bfloat16()
            for _ in range(2))
    got = attn.flash_attention_split(q, k, v)
    want = attn.flash_attention_split_reference(q.float(), k.float(), v.float())
    assert_attention_close(got, want)


def test_split_kernel_is_exact_softmax_above_60(cuda):
    """K4 with logits 80 and 70 in one row at D = 512: exact softmax."""
    s, d = 640, 512
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((1, s, 1, d), generator=g, device=cuda)
    k = torch.randn((1, s, 1, d), generator=g, device=cuda) * 0.1
    v = torch.randn((1, s, 1, d), generator=g, device=cuda)
    scale = d**0.5
    q[0, 0, 0] = 0.0
    q[0, 0, 0, 0], q[0, 0, 0, 1] = 80.0, 70.0
    k[0, 5, 0], k[0, 9, 0] = 0.0, 0.0
    k[0, 5, 0, 0], k[0, 9, 0, 1] = scale, scale  # logits 80 and 70
    v[0, 5, 0], v[0, 9, 0] = 1.0, -1.0
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got = attn.flash_attention_split(q, k, v).float()
    want = attn.flash_attention_split_reference(q.float(), k.float(), v.float())
    torch.testing.assert_close(got, want, rtol=0, atol=BOUND)
    torch.testing.assert_close(got[0, 0, 0], torch.ones(d, device=cuda), rtol=0,
                               atol=1e-2)


@pytest.mark.parametrize("side", [96, 128])
def test_vae_attention_takes_the_split_kernel_at_768(cuda, side):
    """The VAE mid attention at 96x96 latents (768x768 images, 9216 tokens)
    and at SDXL's 128x128 (1024x1024, 16,384 tokens): one K4 launch, the
    same result as its plain path."""
    from gswm_torch.models import layers

    mod = layers.VAEAttention(512).to(cuda, torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((1, 512, side, side), generator=g, device=cuda).bfloat16()
    before = attn.flash_attention_split.launches
    with torch.no_grad():
        got = mod(x).float()
    assert attn.flash_attention_split.launches == before + 1
    xn = mod.group_norm(x).permute(0, 2, 3, 1).reshape(1, side * side, 512).float()
    q, k, v = (F.linear(xn, m.weight.float(), m.bias.float())
               for m in (mod.to_q, mod.to_k, mod.to_v))
    plain = layers.plain_attention(q, k, v, 1)
    want = F.linear(plain, mod.to_out[0].weight.float(), mod.to_out[0].bias.float())
    want = want.reshape(1, side, side, 512).permute(0, 3, 1, 2) + x.float()
    torch.testing.assert_close(got, want, rtol=0, atol=0.1)


def test_flash_kernel_is_exact_softmax_above_60(cuda):
    """Logits 80 and 70 in one row: the kernel keeps exact softmax (weight
    ~1 on the 80 key), where the TPU no-max path would clamp both to 60."""
    s, d = 128, 64
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((1, s, d), generator=g, device=cuda)
    k = torch.randn((1, s, d), generator=g, device=cuda) * 0.1
    v = torch.randn((1, s, d), generator=g, device=cuda)
    q[0, 0] = 0.0
    q[0, 0, 0], q[0, 0, 1] = 80.0, 70.0
    k[0, 5], k[0, 9] = 0.0, 0.0
    k[0, 5, 0], k[0, 9, 1] = 8.0, 8.0
    v[0, 5], v[0, 9] = 1.0, -1.0
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got = attn.flash_attention(q, k, v, 1).float()
    want = attn.flash_attention_reference(q.float(), k.float(), v.float(), 1)
    torch.testing.assert_close(got, want, rtol=0, atol=BOUND)
    torch.testing.assert_close(got[0, 0], torch.ones(d, device=cuda), rtol=0,
                               atol=1e-2)


def test_kernel_wrappers_reject_what_they_do_not_take(cuda):
    x = torch.randn((1, 256, 128), device=cuda)
    w = torch.randn((128, 128), device=cuda)
    with pytest.raises(TypeError):
        attn.fused_qkv_attention(x.double(), w.double(), w.double(), w.double(), 1)  # fp64
    with pytest.raises(TypeError):
        attn.fused_qkv_attention(x.half(), w.half(), w.half(), w.half(), 2)  # fp16
    xb, wb = x.bfloat16(), w.bfloat16()
    with pytest.raises(ValueError):
        attn.fused_qkv_attention(xb[:, :, :96], wb[:, :96], wb[:, :96],
                                 wb[:, :96], 2)  # not contiguous
    with pytest.raises(ValueError):
        attn.fused_qkv_attention(xb[:, :, :96].contiguous(), wb[:96, :96].contiguous(),
                                 wb[:96, :96].contiguous(), wb[:96, :96].contiguous(),
                                 2)  # 96 channels: not a multiple of 64
    with pytest.raises(ValueError):
        attn.flash_attention(xb, xb, xb, 3)  # 128 != 3 x 64
    q4 = torch.randn((1, 600, 1, 128), device=cuda)
    with pytest.raises(TypeError):
        attn.flash_attention_split(*(q4.half(),) * 3, return_lse=True)  # fp16 with lse
    qb = q4.bfloat16()
    with pytest.raises(ValueError):
        attn.flash_attention_split(qb[..., :96], qb[..., :96], qb[..., :96])  # strided
    for d in (36, 520):  # D % 8 != 0 (rows not 16-byte multiples), D > 512
        qd = torch.zeros((1, 600, 1, d), device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError):
            attn.flash_attention_split(qd, qd, qd)
    with pytest.raises(ValueError):  # 8 heads of 36
        attn.flash_attention(*(torch.zeros((1, 300, 288), device=cuda,
                                           dtype=torch.bfloat16),) * 3, 8)
    flat = torch.zeros(600 * 128 + 1, device=cuda, dtype=torch.bfloat16)
    odd = flat[1:].view(1, 600, 1, 128)  # 2-byte offset: not 16-byte aligned
    with pytest.raises(ValueError):
        attn.flash_attention_split(odd, odd, odd)


# The float32 kernels (csrc/qkv_proj_f32.cu, csrc/flash_f32.cu) against
# their fp32 plain versions, TF32 off (the fixture): within this share of max
# |want|.  Against float64 fp32 reads ~1e-6 at these widths and N(0, 1)
# inputs; TF32-rounded operands 3e-4 to 7e-4.
F32_BOUND = 1e-5


def assert_f32_close(got, want):
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
    err = (got - want).abs().max().item()
    assert err <= F32_BOUND * want.abs().max().item(), err


def _launches(*wrappers):
    """Each wrapper's bf16 launches (by head dim too) and fp32 launches."""
    return [(w.launches, dict(getattr(w, "launches_by_d", {})), w.launches_f32)
            for w in wrappers]


def _f32_by_d(*wrappers):
    return [dict(w.launches_f32_by_d) for w in wrappers]


def _one_more_f32(before, after):
    """One fp32 launch more on each wrapper, no bf16 launch."""
    return all(a == (n, by_d, f32 + 1) for (n, by_d, f32), a in zip(before, after))


@pytest.mark.parametrize("m,c,n", [(1, 64, 64), (77, 640, 640), (1001, 1280, 1280),
                                   (300, 128, 192), (4 * 1024, 640, 640),
                                   (4 * 256, 1280, 1280)])
def test_f32_projection_kernel_matches_plain(cuda, m, c, n):
    """The fp32 GEMM at ragged M (1, 77, 1001, 300: no multiple of the
    128-row tile), N = 192 (half a column tile past N) and the 512x512
    path's (B * 1024, 640, 640) and (B * 256, 1280, 1280)."""
    g = torch.Generator(device=cuda).manual_seed(m + c)
    x = torch.randn((1, m, c), generator=g, device=cuda)
    ws = [torch.randn((n, c), generator=g, device=cuda) for _ in range(3)]
    before = _launches(attn.qkv_projection)
    got = attn.qkv_projection(x, *ws)
    after = _launches(attn.qkv_projection)
    assert after == [(before[0][0], {}, before[0][2] + 1)]
    for a, w in zip(got, attn.qkv_projection_reference(x, *ws)):
        assert_f32_close(a, w)


@pytest.mark.parametrize("b,s,h", [(1, 1, 1), (1, 77, 3), (2, 1001, 2), (3, 65, 2),
                                   (4, 256, 20), (4, 1024, 10), (2, 4096, 5)])
def test_f32_flash_kernel_matches_plain(cuda, b, s, h):
    """The fp32 flash core through the natural-layout wrapper (K2) at
    ragged S (1, 77, 1001, 65: B * S no multiple of the 64-row tile) and
    the 512x512 path's levels 2, 1 and 0; every head on its own scale."""
    g = torch.Generator(device=cuda).manual_seed(s + h)
    q, k, v = (torch.randn((b, s, h * 64), generator=g, device=cuda) for _ in range(3))
    before = _launches(attn.flash_attention)
    got = attn.flash_attention(q, k, v, h)
    assert _one_more_f32(before, _launches(attn.flash_attention))
    want = attn.flash_attention_reference(q, k, v, h)
    for i in range(h):
        assert_f32_close(got.view(b, s, h, 64)[:, :, i], want.view(b, s, h, 64)[:, :, i])


@pytest.mark.parametrize("b,s,c,h", [(1, 77, 128, 2), (1, 256, 1280, 20),
                                     (2, 1001, 640, 10), (1, 1024, 640, 10)])
def test_f32_fused_qkv_kernels_match_plain(cuda, b, s, c, h):
    """K1 in fp32: the fp32 GEMM, then the fp32 core, one wrapper launch."""
    g = torch.Generator(device=cuda).manual_seed(s + c)
    x = torch.randn((b, s, c), generator=g, device=cuda)
    ws = [torch.randn((h * 64, c), generator=g, device=cuda) * c**-0.5 for _ in range(3)]
    before = _launches(attn.fused_qkv_attention, attn.qkv_projection, attn.flash_attention)
    got = attn.fused_qkv_attention(x, *ws, h)
    after = _launches(attn.fused_qkv_attention, attn.qkv_projection, attn.flash_attention)
    assert _one_more_f32(before[:1], after[:1]) and before[1:] == after[1:]
    assert_f32_close(got, attn.fused_qkv_attention_reference(x, *ws, h))


@pytest.mark.parametrize("b,sq,sk,h", [(1, 77, 1001, 3), (2, 1001, 512, 2),
                                       (1, 1, 577, 1), (1, 4096, 4096, 1)])
def test_f32_split_kernel_matches_plain(cuda, b, sq, sk, h):
    """K4 at d = 64 in fp32 without the log-sum-exp: the fp32 core at
    Sq != Sk, ragged key tails masked."""
    g = torch.Generator(device=cuda).manual_seed(sq + sk)
    q = torch.randn((b, sq, h, 64), generator=g, device=cuda)
    k, v = (torch.randn((b, sk, h, 64), generator=g, device=cuda) for _ in range(2))
    before = _launches(attn.flash_attention_split)
    got = attn.flash_attention_split(q, k, v)
    assert _one_more_f32(before, _launches(attn.flash_attention_split))
    assert_f32_close(got, attn.flash_attention_split_reference(q, k, v))


def _f32_refusals(cuda):
    """(label, call, the dtype its message must name) where no kernel takes
    the tensors: float16 in every wrapper (float32 runs everywhere since the
    packed, transposed and log-sum-exp forms of flash_f32.cu), float64."""
    half = dict(device=cuda, dtype=torch.float16)
    q64 = torch.zeros((1, 600, 2, 64), **half)
    q512 = torch.zeros((1, 600, 1, 512), dtype=torch.float64, device=cuda)
    h64 = torch.zeros((1, 64, 128), **half)
    h512 = torch.zeros((1, 600, 1, 512), **half)
    return [
        ("K4 with lse in float16",
         lambda: attn.flash_attention_split(q64, q64, q64, return_lse=True), "float16"),
        ("K4 with lse at d = 512 in float64",
         lambda: attn.flash_attention_split(q512, q512, q512, return_lse=True), "float64"),
        ("K6 in float16", lambda: attn.flash_attention_packed(torch.zeros((1, 64, 384), **half)),
         "float16"),
        ("K7 in float16",
         lambda: attn.flash_attention_transposed(torch.zeros((384, 1, 64), **half), 2),
         "float16"),
        ("K7 at d = 80 in float16",
         lambda: attn.flash_attention_transposed(torch.zeros((480, 1, 64), **half), 2),
         "float16"),
        ("K2 in float16", lambda: attn.flash_attention(h64, h64, h64, 2), "float16"),
        ("K1's GEMM in float16",
         lambda: attn.qkv_projection(h64, *(torch.zeros((128, 128), **half),) * 3),
         "float16"),
        ("K1 in float16",
         lambda: attn.fused_qkv_attention(h64, *(torch.zeros((128, 128), **half),) * 3, 2),
         "float16"),
        ("K4 in float16 at d = 512", lambda: attn.flash_attention_split(h512, h512, h512),
         "float16"),
    ]


@pytest.mark.parametrize("case", range(9))
def test_f32_wrappers_raise_where_no_kernel_takes_it(cuda, case):
    """float16 (and float64) in every wrapper: a TypeError naming the dtype,
    and no launch (no plain version either)."""
    label, call, dtype = _f32_refusals(cuda)[case]
    wrappers = (attn.flash_attention, attn.fused_qkv_attention, attn.flash_attention_split,
                attn.flash_attention_packed, attn.flash_attention_transposed)
    before = [(w.launches, getattr(w, "launches_f32", 0)) for w in wrappers]
    with pytest.raises(TypeError, match=dtype):
        call()
    assert [(w.launches, getattr(w, "launches_f32", 0)) for w in wrappers] == before, label


def _f32_served(cuda):
    """(label, wrapper, call, plain version, head dim): fp32 calls that
    raised before the kernels took every natural-layout head dim."""
    g = torch.Generator(device=cuda).manual_seed(1919)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=cuda) * scale

    q80 = [rand(1, 64, 2 * 80) for _ in range(3)]
    x640, w80 = rand(1, 256, 640), [rand(640, 640, scale=640**-0.5) for _ in range(3)]
    q128 = [rand(1, 600, 2, 128) for _ in range(3)]
    qkv = rand(2, 577, 3 * 2 * 128)
    qkv_t = rand(3 * 3 * 80, 2, 1001)
    vae = layers.VAEAttention(512).to(cuda).requires_grad_(False)
    x65 = rand(1, 512, 65, 65)
    with torch.no_grad():
        for p_ in vae.parameters():
            p_.copy_(torch.randn(p_.shape, generator=g, device=cuda) * 0.02)
    return [
        ("K2 at d = 80", attn.flash_attention, lambda: attn.flash_attention(*q80, 2),
         lambda: attn.flash_attention_reference(*q80, 2), 80),
        ("K1 at d = 80", attn.fused_qkv_attention,
         lambda: attn.fused_qkv_attention(x640, *w80, 8),
         lambda: attn.fused_qkv_attention_reference(x640, *w80, 8), 80),
        ("K4 at d = 128", attn.flash_attention_split,
         lambda: attn.flash_attention_split(*q128),
         lambda: attn.flash_attention_split_reference(*q128), 128),
        # an fp32 pipeline's image_to_latents above 512x512: the VAE's mid
        # attention over 65 x 65 tokens takes K4 at d = 512
        ("the VAE's attention above 4096 tokens", attn.flash_attention_split,
         lambda: vae(x65), lambda: _plain_split(lambda: vae(x65)), 512),
        ("K6", attn.flash_attention_packed, lambda: attn.flash_attention_packed(qkv),
         lambda: attn.flash_attention_packed_reference(qkv), 64),
        ("K7 at d = 80, S = 1001", attn.flash_attention_transposed,
         lambda: attn.flash_attention_transposed(qkv_t, 3),
         lambda: attn.flash_attention_transposed_reference(qkv_t, 3), 80),
    ]


def _plain_split(call):
    """``call`` with the split wrapper's plain version in place of the kernel."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "flash_attention_split", attn.flash_attention_split_reference)
        return call()


@pytest.mark.parametrize("case", range(6))
def test_f32_wrappers_serve_what_they_refused_before(cuda, case):
    """fp32 at d = 80 (K2, K1) and 128 (K4), the VAE's attention in fp32
    above 4096 tokens (K4 at d = 512), K6 and K7: one fp32 launch, counted
    at its head dim, no bf16 launch, within F32_BOUND of the plain
    version."""
    label, wrapper, call, plain, d = _f32_served(cuda)[case]
    before, by_d = _launches(wrapper), _f32_by_d(wrapper)[0]
    with torch.inference_mode():
        got = call()
    assert _one_more_f32(before, _launches(wrapper)), label
    assert _f32_by_d(wrapper)[0] == {**by_d, d: by_d.get(d, 0) + 1}, label
    with torch.inference_mode():
        assert_f32_close(got, plain())


# Head dims of the float32 core, flash_f32.cu, by its 64-column panels: one
# (8, 40, 56, 64), two (72 and 80: the last of 8 and 16 columns; 128), three
# (160, 192), four (256), eight (512)
F32_HEAD_DIMS = (8, 40, 56, 64, 72, 80, 128, 160, 192, 256, 512)
# (Sq, Sk), Sq != Sk: one row and one key, a ragged 64-row tile, several
F32_LENGTHS = ((1, 577), (65, 1001), (577, 65), (1001, 1))


def _f32_call(q, k, v) -> torch.Tensor:
    """The fp32 core through its C entry, at any Sq and Sk (the split
    wrapper takes its einsum branch below 512 keys)."""
    from gswm_torch import native

    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    native.library().call("gswm_flash_f32", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), b, sq, k.shape[1], h, d,
                          native.stream_handle(q.device))
    return out


@pytest.mark.parametrize("sq,sk", F32_LENGTHS)
@pytest.mark.parametrize("d", F32_HEAD_DIMS)
def test_f32_flash_kernels_any_head_dim(cuda, d, sq, sk):
    """The fp32 core at every panel count, Sq != Sk, two batches and
    three heads, each head against the plain version on its own scale; v =
    1 shows that no key past Sk (the zeros of a ragged tile) and no key of
    the other batch is weighed: every output is 1 within float32 rounding."""
    b, h = 2, 3
    g = torch.Generator(device=cuda).manual_seed(d * 7 + sq + sk)
    q = torch.randn((b, sq, h, d), generator=g, device=cuda)
    k, v = (torch.randn((b, sk, h, d), generator=g, device=cuda) for _ in range(2))
    got = _f32_call(q, k, v)
    want = attn.flash_attention_split_reference(q, k, v)
    for i in range(h):
        assert_f32_close(got[:, :, i], want[:, :, i])
    ones = _f32_call(q, k, torch.ones_like(v))
    assert (ones - 1).abs().max().item() <= 1e-5


def _f32_natural(q, k, v) -> torch.Tensor:
    """The fp32 core through the natural-layout wrapper (Sq == Sk), on the
    key split ``f32_key_splits`` gives the shape."""
    b, s, h, d = q.shape
    return attn.flash_attention(*(t.reshape(b, s, h * d) for t in (q, k, v)), h).view(
        b, s, h, d)


def _f64_attention(q, k, v):
    """softmax(q k^T d^-0.5) v and its log-sum-exp in float64."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * d**-0.5
    return (torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v.double()),
            torch.logsumexp(logits, -1))


def assert_f64_close(got, want):
    """Within F32_BOUND of max |want| against a float64 want."""
    err = (got.double() - want).abs().max().item()
    assert err <= F32_BOUND * want.abs().max().item(), err


@pytest.mark.parametrize("d", range(8, 513, 8))
def test_f32_core_every_head_dim_split_and_against_float64(cuda, d):
    """The 3xTF32 core at every d % 8 == 0 from 8 to 512 (the exact-width
    instances at 40, 80, 160 among the 64-column ones), ragged Sq != Sk =
    (1001, 577): the split wrapper, on its key split (s > 1: 577 keys are 10
    tiles, 16 blocks on the card's SMs), within F32_BOUND of float64, lse
    included and its output bit-equal to the call without; the unsplit
    entry within F32_BOUND of float64 too; the transposed and natural
    routes bit-equal at Sq == Sk = 1001, split as well."""
    b, h = 1, 2
    g = torch.Generator(device=cuda).manual_seed(d)
    q = torch.randn((b, 1001, h, d), generator=g, device=cuda)
    k, v = (torch.randn((b, 577, h, d), generator=g, device=cuda) for _ in range(2))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert attn.f32_key_splits(b, 1001, 577, h, d, sms) > 1
    out, lse = attn.flash_attention_split(q, k, v, return_lse=True)
    want, want_lse = _f64_attention(q, k, v)
    assert_f64_close(out, want)
    assert (lse.double() - want_lse).abs().max().item() <= F32_BOUND * max(
        1.0, want_lse.abs().max().item())
    assert torch.equal(out, attn.flash_attention_split(q, k, v))
    assert_f64_close(_f32_call(q, k, v), want)
    qkv_t = torch.randn((3 * h * d, b, 1001), generator=g, device=cuda)
    qn, kn, vn = (t.permute(2, 3, 0, 1).contiguous() for t in qkv_t.view(3, h, d, b, 1001))
    assert attn.f32_key_splits(b, 1001, 1001, h, d, sms) > 1
    assert torch.equal(attn.flash_attention_transposed(qkv_t, h),
                       _f32_natural(qn, kn, vn).permute(2, 3, 0, 1).reshape(h * d, b, 1001))


@pytest.mark.parametrize("d", [40, 64, 160, 512])
def test_f32_key_split_steps_agree_at_every_split(cuda, d):
    """The three C steps by hand (pre-pass, core over s chunks, combine) at
    s = 1 ... 5 over 577 keys (10 tiles: chunks of 10, 5, 4, 3 and 2 tiles,
    the last ragged), the output and lse each within F32_BOUND of float64;
    the pre-pass's scratch bit-equal to its plain version."""
    from gswm_torch import native

    b, sq, sk, h = 2, 300, 577, 3
    g = torch.Generator(device=cuda).manual_seed(d + 1)
    q = torch.randn((b, sq, h, d), generator=g, device=cuda)
    k, v = (torch.randn((b, sk, h, d), generator=g, device=cuda) for _ in range(2))
    lib, stream = native.library(), native.stream_handle(cuda)
    scratch = torch.empty(attn.f32_scratch_numel(b, sk, h, d), device=cuda)
    lib.call("gswm_flash_f32_prepass", k.data_ptr(), v.data_ptr(), scratch.data_ptr(), b, sk,
             h, d, h * d, 0, stream)
    assert torch.equal(scratch, attn.f32_prepass_reference(k, v))
    want, want_lse = _f64_attention(q, k, v)
    for splits in range(1, 6):
        out, lse = torch.empty_like(q), torch.empty((b, h, sq), device=cuda)
        ws = torch.empty(attn.f32_workspace_numel(splits, b, sq, h, d), device=cuda)
        lib.call("gswm_flash_f32_core", q.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), ws.data_ptr() if splits > 1 else None, b, sq, sk, h, d,
                 h * d, h * d, 0, 1, splits, stream)
        if splits > 1:
            lib.call("gswm_flash_f32_combine", ws.data_ptr(), out.data_ptr(), lse.data_ptr(),
                     b, sq, h, d, h * d, 0, splits, stream)
        assert_f64_close(out, want)
        assert (lse.double() - want_lse).abs().max().item() <= F32_BOUND * max(
            1.0, want_lse.abs().max().item()), splits


@pytest.mark.parametrize("m,c,n", [(4096, 640, 640), (1024, 1280, 1280), (2304, 1280, 1280),
                                   (77, 2560, 192)])
def test_f32_projection_against_float64(cuda, m, c, n):
    """The 3xTF32 GEMM against the float64 product within F32_BOUND of max
    |want|, C up to 2560 (each 32-deep slice summed apart, the slices added
    in fp32)."""
    g = torch.Generator(device=cuda).manual_seed(m + n)
    x = torch.randn((1, m, c), generator=g, device=cuda)
    ws = [torch.randn((n, c), generator=g, device=cuda) for _ in range(3)]
    for got, w in zip(attn.qkv_projection(x, *ws), ws):
        assert_f64_close(got, x.double() @ w.double().t())


def _f32_lse_call(q, k, v):
    """The fp32 core with its log-sum-exp through its C entry, at any Sq and
    Sk (the split wrapper takes its einsum branch below 512 keys)."""
    from gswm_torch import native

    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), device=q.device)
    native.library().call("gswm_flash_f32_lse", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), lse.data_ptr(), b, sq, k.shape[1], h, d,
                          native.stream_handle(q.device))
    return out, lse


@pytest.mark.parametrize("sq,sk", F32_LENGTHS)
@pytest.mark.parametrize("d", F32_HEAD_DIMS)
def test_f32_lse_kernel_any_head_dim(cuda, d, sq, sk):
    """K4 + lse in fp32 at every panel count, Sq != Sk: the output bit-equal
    to the call without lse, the lse within 1e-5 of max(1, max |lse|) of
    float64 logsumexp of the logits, rows past Sq unwritten."""
    b, h = 2, 3
    g = torch.Generator(device=cuda).manual_seed(d * 11 + sq + sk)
    q = torch.randn((b, sq, h, d), generator=g, device=cuda)
    k, v = (torch.randn((b, sk, h, d), generator=g, device=cuda) for _ in range(2))
    out, lse = _f32_lse_call(q, k, v)
    assert torch.equal(out, _f32_call(q, k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * d**-0.5
    want = torch.logsumexp(logits, -1)
    assert lse.shape == want.shape
    assert (lse.double() - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())


def test_f32_lse_wrapper_counts_apart(cuda):
    """``flash_attention_split(..., return_lse=True)`` in fp32 launches the
    fp32 kernel with its lse, counted on ``lse_launches_f32[_by_d]`` alone."""
    split = attn.flash_attention_split
    g = torch.Generator(device=cuda).manual_seed(2020)
    q = torch.randn((2, 600, 2, 40), generator=g, device=cuda)
    k, v = (torch.randn((2, 1001, 2, 40), generator=g, device=cuda) for _ in range(2))
    before = (split.launches, split.launches_f32, split.lse_launches,
              split.lse_launches_f32, dict(split.lse_launches_f32_by_d))
    out, lse = split(q, k, v, return_lse=True)
    assert (split.launches, split.launches_f32, split.lse_launches,
            split.lse_launches_f32) == (*before[:3], before[3] + 1)
    assert split.lse_launches_f32_by_d[40] == before[4].get(40, 0) + 1
    want, want_lse = attn.flash_attention_split_lse_reference(q, k, v)
    assert_f32_close(out, want)
    assert (lse - want_lse).abs().max().item() <= 1e-5 * max(1.0, want_lse.abs().max().item())


@pytest.mark.parametrize("b,s,h", [(1, 1, 1), (2, 577, 3), (1, 1001, 2), (2, 4096, 5),
                                   (4, 256, 20)])
def test_f32_packed_kernel_matches_plain_and_the_natural_kernel(cuda, b, s, h):
    """K6 in fp32 at ragged S and odd head counts (a zero pad head): within
    F32_BOUND of the plain version, each head on its own scale, and bit-equal
    to the natural form on the same heads made contiguous (both on the key
    split of the shape); the unsplit entries likewise."""
    pairs = -(-h // 2)
    g = torch.Generator(device=cuda).manual_seed(s * 3 + h)
    qkv = torch.randn((b, s, 3 * pairs * 128), generator=g, device=cuda)
    before = _launches(attn.flash_attention_packed)
    got = attn.flash_attention_packed(qkv)
    assert _one_more_f32(before, _launches(attn.flash_attention_packed))
    want = attn.flash_attention_packed_reference(qkv)
    for i in range(h):
        assert_f32_close(got[..., 64 * i:64 * i + 64], want[..., 64 * i:64 * i + 64])
    q, k, v = (t.reshape(b, s, 2 * pairs, 64).contiguous() for t in qkv.split(pairs * 128, -1))
    assert torch.equal(got, _f32_natural(q, k, v).reshape(b, s, pairs * 128))
    from gswm_torch import native

    unsplit = qkv.new_empty((b, s, pairs * 128))
    native.library().call("gswm_flash_f32_packed", qkv.data_ptr(), unsplit.data_ptr(), b, s,
                          pairs, native.stream_handle(qkv.device))
    assert torch.equal(unsplit, _f32_call(q, k, v).reshape(b, s, pairs * 128))


def _f32_transposed(qkv_t, h, entry="gswm_flash_f32_transposed"):
    from gswm_torch import native

    n3, b, s = qkv_t.shape
    out = qkv_t.new_empty((n3 // 3, b, s))
    native.library().call(entry, qkv_t.data_ptr(), out.data_ptr(), b, s, h, n3 // (3 * h),
                          native.stream_handle(qkv_t.device))
    return out


@pytest.mark.parametrize("s", [1, 64, 577, 1001, 1024, 324])
@pytest.mark.parametrize("d", F32_HEAD_DIMS)
def test_f32_transposed_kernel_any_head_dim(cuda, d, s):
    """K7 in fp32 at every panel count, at S = 1, 577 and 1001 (4-byte
    copies) and 64, 1024, 324 (16-byte ones): two batches, three heads,
    each head within F32_BOUND of the plain version; bit-equal to the
    natural form on the same q, k and v (both on the key split of the
    shape; the unsplit entries likewise), and the 4-byte form bit-equal to
    the 16-byte one; counted by the kernel ``transposed_kernel`` names."""
    b, h = 2, 3
    g = torch.Generator(device=cuda).manual_seed(d * 5 + s)
    qkv_t = torch.randn((3 * h * d, b, s), generator=g, device=cuda)
    kernel = attn.transposed_kernel(d, s, torch.float32)
    by_kernel = attn.flash_attention_transposed.launches_by_kernel
    before = (by_kernel.get(kernel, 0), _launches(attn.flash_attention_transposed))
    got = attn.flash_attention_transposed(qkv_t, h)
    assert by_kernel[kernel] == before[0] + 1
    assert _one_more_f32(before[1], _launches(attn.flash_attention_transposed))
    want = attn.flash_attention_transposed_reference(qkv_t, h)
    for i in range(h):
        assert_f32_close(got[i * d:(i + 1) * d], want[i * d:(i + 1) * d])
    q, k, v = (t.permute(2, 3, 0, 1).contiguous() for t in qkv_t.view(3, h, d, b, s))
    assert torch.equal(got, _f32_natural(q, k, v).permute(2, 3, 0, 1).reshape(h * d, b, s))
    unsplit = _f32_transposed(qkv_t, h)
    assert torch.equal(unsplit, _f32_call(q, k, v).permute(2, 3, 0, 1).reshape(h * d, b, s))
    assert torch.equal(unsplit, _f32_transposed(qkv_t, h, "gswm_flash_f32_transposed_4byte"))
    ones = qkv_t.clone()
    ones[2 * h * d:] = 1.0  # v = 1: no key of the other batch or past S is weighed
    assert (_f32_transposed(ones, h) - 1).abs().max().item() <= 1e-5


def test_f32_transposed_output_stays_in_place(cuda):
    """The (H D, B, S) output between guard regions: nothing written past
    it at an odd S (4-byte copies) or in another head's rows; the output
    the unsplit natural entry's on the same q, k and v, bit for bit."""
    b, s, h, d = 2, 1001, 2, 80
    g = torch.Generator(device=cuda).manual_seed(7)
    qkv_t = torch.randn((3 * h * d, b, s), generator=g, device=cuda)
    from gswm_torch import native

    guard = torch.full((h * d * b * s + 2 * 4096,), 7.0, device=cuda)
    out = guard[4096:4096 + h * d * b * s]
    native.library().call("gswm_flash_f32_transposed", qkv_t.data_ptr(), out.data_ptr(), b, s,
                          h, d, native.stream_handle(qkv_t.device))
    torch.cuda.synchronize()
    assert (guard[:4096] == 7.0).all() and (guard[-4096:] == 7.0).all()
    q, k, v = (t.permute(2, 3, 0, 1).contiguous() for t in qkv_t.view(3, h, d, b, s))
    assert torch.equal(out.view(h * d, b, s),
                       _f32_call(q, k, v).permute(2, 3, 0, 1).reshape(h * d, b, s))


@pytest.mark.parametrize("shape,eps,act", [
    ((2, 64, 1, 1), 1e-5, None), ((1, 320, 300, 1), 1e-5, "silu"),
    ((2, 1280, 12, 12), 1e-5, "silu"), ((2, 320, 96, 96), 1e-5, "silu"),
    ((1, 960, 96, 96), 1e-5, None), ((1, 512, 192, 192), 1e-6, "silu"),
    ((1, 128, 768, 768), 1e-6, "silu"), ((1, 256, 768, 768), 1e-6, None),
    ((1, 32768, 24, 24), 1e-5, "silu"), ((3, 64, 512, 512), 1e-5, None),
    # H * W no multiple of 4: the element-wise instance
    ((1, 128, 385, 385), 1e-6, "silu"), ((3, 96, 7, 9), 1e-5, "silu")])
def test_f32_group_norm_kernel_matches_plain(cuda, shape, eps, act):
    """K8 in fp32 against the JAX op's formulas in float64: within 1e-5 of
    max |want| (fp32 sums in another order; the fast exponential of the SiLU
    a few ulp) or, where the formula itself is ill-conditioned in fp32
    (var = E[x^2] - E[x]^2 of a group of two elements, (2, 64, 1, 1)), within
    four times the fp32 plain version's own error; an fp32 output, one
    launch on ``launches_f32``."""
    g = torch.Generator(device=cuda).manual_seed(shape[1] + shape[2] + 1)
    x = torch.randn(shape, generator=g, device=cuda) * 2 + 0.5
    w = 1 + 0.05 * torch.randn(shape[1], generator=g, device=cuda)
    b = 0.05 * torch.randn(shape[1], generator=g, device=cuda)
    before = (gn.fused_group_norm.launches, gn.fused_group_norm.launches_f32)
    got = gn.fused_group_norm(x, w, b, 32, eps, act)
    assert (gn.fused_group_norm.launches, gn.fused_group_norm.launches_f32) == \
        (before[0], before[1] + 1)
    xd = x.double().reshape(shape[0], 32, -1)
    mean = xd.mean(dim=-1, keepdim=True)
    var = (xd.square().mean(dim=-1, keepdim=True) - mean.square()).clamp(min=0.0)
    want = ((xd - mean) * torch.rsqrt(var + eps)).reshape(shape) * \
        w.double().reshape(1, -1, 1, 1) + b.double().reshape(1, -1, 1, 1)
    if act == "silu":
        want = want * torch.sigmoid(want)
    plain_err = (gn.fused_group_norm_reference(x, w, b, 32, eps, act).double() - want).abs().max()
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = (got.double() - want).abs().max().item()
    assert err <= max(1e-5 * want.abs().max().item(), 4 * plain_err.item()), (err, plain_err)


def test_f32_launches_count_by_head_dim(cuda):
    """``launches_f32_by_d`` of the natural, split and fused-qkv wrappers:
    one at each call's head dim, and the bf16 counters still."""
    f32 = dict(device=cuda, dtype=torch.float32)
    wrappers = (attn.flash_attention, attn.flash_attention_split, attn.fused_qkv_attention)
    before, by_d = _launches(*wrappers), _f32_by_d(*wrappers)
    attn.flash_attention(*(torch.ones((1, 100, 8 * 40), **f32),) * 3, 8)
    attn.flash_attention(*(torch.ones((1, 100, 2 * 80), **f32),) * 3, 2)
    attn.flash_attention_split(*(torch.ones((1, 600, 1, 512), **f32),) * 3)
    attn.fused_qkv_attention(torch.ones((1, 256, 1280), **f32),
                             *(torch.ones((1280, 1280), **f32) * 1e-3,) * 3, 8)
    after, by_d_after = _launches(*wrappers), _f32_by_d(*wrappers)
    assert [a[:2] for a in after] == [b_[:2] for b_ in before]
    assert [a[2] - b_[2] for a, b_ in zip(after, before)] == [2, 1, 1]
    want = [{40: 1, 80: 1}, {512: 1}, {160: 1}]
    assert [{d: n - old.get(d, 0) for d, n in new.items() if n != old.get(d, 0)}
            for new, old in zip(by_d_after, by_d)] == want


def test_f32_unet_forward_on_card(cuda):
    """sd-2-1-base's UNet at 512x512 in float32, batch 1, random weights: the
    fp32 K1 10 and the fp32 K2 5 times, no bf16 attention kernel, a finite
    output."""
    pipe = paths.build_pipeline("sd-2-1-base", dtype=torch.float32)
    inputs = paths.unet_inputs(pipe, 1, res=paths.RES_512)
    wrappers = (attn.fused_qkv_attention, attn.flash_attention, attn.flash_attention_split,
                attn.flash_attention_packed, attn.flash_attention_transposed)
    before = [(w.launches, getattr(w, "launches_f32", 0)) for w in wrappers]
    with torch.inference_mode():
        out = pipe.unet(*inputs)
    made = [(w.launches - n, getattr(w, "launches_f32", 0) - f)
            for w, (n, f) in zip(wrappers, before)]
    assert made == [(0, 10), (0, 5), (0, 0), (0, 0), (0, 0)]
    assert out.dtype == torch.float32 and out.shape == (1, 4, 64, 64)
    assert torch.isfinite(out).all()


def test_f32_sd14_unet_forward_on_card(cuda):
    """sd-1-4's UNet at 512x512 in float32, batch 1, random weights: per
    forward the fp32 K2 5 times at d = 40 and the fp32 K1 5 times at 80 and
    5 at 160, no bf16 attention kernel, a finite output; float16 is refused
    at construction."""
    from gswm_torch.pipelines import InversablePipeline

    with pytest.raises(NotImplementedError, match="torch.float16"):
        InversablePipeline("sd-1-4", device=cuda, dtype=torch.float16)
    pipe = paths.build_pipeline("sd-1-4", dtype=torch.float32)
    inputs = paths.unet_inputs(pipe, 1, res=paths.RES_512)
    wrappers = (attn.fused_qkv_attention, attn.flash_attention, attn.flash_attention_split,
                attn.flash_attention_packed, attn.flash_attention_transposed)
    before = [w.launches for w in wrappers]
    by_d = _f32_by_d(*wrappers[:3])
    with torch.inference_mode():
        out = pipe.unet(*inputs)
    assert [w.launches for w in wrappers] == before
    assert [{d: n - old.get(d, 0) for d, n in new.items() if n != old.get(d, 0)}
            for new, old in zip(_f32_by_d(*wrappers[:3]), by_d)] == \
        [{80: 5, 160: 5}, {40: 5}, {}]
    assert out.dtype == torch.float32 and out.shape == (1, 4, 64, 64)
    assert torch.isfinite(out).all()


# Head dims other than 64: flash_hopper.cu below (8, 40), flash_mid.cu above
# (72, 80: one whole panel and a tail of 16 columns, 8 or 16 of them real;
# 160: two and a tail of 32)
HEAD_DIMS = (8, 40, 72, 80, 160)


def assert_every_head_close(got, want):
    """(B, S, H, D): each head on its own scale, so a head that a store past
    D overwrote, or a tile read from the neighbouring head, cannot hide
    behind the others."""
    for h in range(got.shape[2]):
        assert_attention_close(got[:, :, h], want[:, :, h])


@pytest.mark.parametrize("s", [1001, 4096])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_kernel_any_head_dim(cuda, d, s):
    """K2 on natural-layout (B, S, 8 * D) q/k/v: the tensor maps are over the
    true D, so the kernel reads zeros past D and drops its own columns
    there; SD 1.x's level 0 is (4096, 8 heads of 40); 1001 tokens leave
    ragged key and query tiles."""
    b, h = 2, 8
    g = torch.Generator(device=cuda).manual_seed(s + d)
    q, k, v = (torch.randn((b, s, h * d), generator=g, device=cuda).bfloat16()
               for _ in range(3))
    before = attn.flash_attention.launches_by_d.get(d, 0)
    got = attn.flash_attention(q, k, v, h)
    assert attn.flash_attention.launches_by_d[d] == before + 1
    want = attn.flash_attention_reference(q.float(), k.float(), v.float(), h)
    assert_every_head_close(got.view(b, s, h, d), want.view(b, s, h, d))


@pytest.mark.parametrize("sq,sk", [(1001, 1001), (65, 577), (1024, 1024)])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_split_kernel_any_head_dim(cuda, d, sq, sk):
    """K4 at head dims off the 64-column panels, every head against the
    plain version, ragged tiles of keys and queries; v = 1 shows the keys
    TMA zero-fills past Sk are masked."""
    b, h = 2, 3
    g = torch.Generator(device=cuda).manual_seed(sq + sk + d)
    q = torch.randn((b, sq, h, d), generator=g, device=cuda).bfloat16()
    k, v = (torch.randn((b, sk, h, d), generator=g, device=cuda).bfloat16()
            for _ in range(2))
    before = attn.flash_attention_split.launches_by_d.get(d, 0)
    got = attn.flash_attention_split(q, k, v)
    assert attn.flash_attention_split.launches_by_d[d] == before + 1
    assert_every_head_close(got, attn.flash_attention_split_reference(
        q.float(), k.float(), v.float()))
    ones = attn.flash_attention_split(q, k, torch.ones_like(v)).float()
    torch.testing.assert_close(ones, torch.ones_like(ones), rtol=0, atol=2**-7)


@pytest.mark.parametrize("b,s,d", [(1, 1001, d) for d in HEAD_DIMS]
                         + [(4, 1024, 80), (4, 256, 160), (8, 256, 160)])
def test_fused_qkv_kernel_any_head_dim(cuda, b, s, d):
    """K1 with 8 heads of D and C = 8 * D channels (SD 1.x: 640 at D = 80,
    1280 at 160): the GEMM writes (B, S, 8 * D), the core reads it at the
    true D; every head against the plain version."""
    h = 8
    c = h * d
    g = torch.Generator(device=cuda).manual_seed(s + d)
    x = torch.randn((b, s, c), generator=g, device=cuda).bfloat16()
    ws = [(torch.randn((h * d, c), generator=g, device=cuda) * c**-0.5).bfloat16()
          for _ in range(3)]
    before = attn.fused_qkv_attention.launches_by_d.get(d, 0)
    got = attn.fused_qkv_attention(x, *ws, h)
    assert attn.fused_qkv_attention.launches_by_d[d] == before + 1
    want = attn.fused_qkv_attention_reference(x.float(), *(w.float() for w in ws), h)
    assert_every_head_close(got.view(b, s, h, d), want.view(b, s, h, d))


@pytest.mark.parametrize("layout", ["natural", "split"])
def test_kernels_are_exact_softmax_above_60_at_head_dim_40(cuda, layout):
    """Logits 80 and 70 in one row at D = 40, where the scale 40^-0.5 is no
    power of two and the kernel scales q in shared memory: exact softmax
    (weight ~1 on the 80 key), where the TPU no-max path would clamp both
    to 60."""
    s, d = 640, 40
    g = torch.Generator(device=cuda).manual_seed(40)
    q = torch.randn((1, s, 1, d), generator=g, device=cuda)
    k = torch.randn((1, s, 1, d), generator=g, device=cuda) * 0.1
    v = torch.randn((1, s, 1, d), generator=g, device=cuda)
    q[0, 0, 0] = 0.0
    q[0, 0, 0, 0], q[0, 0, 0, 1] = 80.0, 70.0
    k[0, 5, 0], k[0, 9, 0] = 0.0, 0.0
    k[0, 5, 0, 0], k[0, 9, 0, 1] = d**0.5, d**0.5  # logits ~80 and ~70
    v[0, 5, 0], v[0, 9, 0] = 1.0, -1.0
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    if layout == "natural":
        got = attn.flash_attention(*(t.view(1, s, d) for t in (q, k, v)), 1)
        got = got.view(1, s, 1, d).float()
    else:
        got = attn.flash_attention_split(q, k, v).float()
    want = attn.flash_attention_split_reference(q.float(), k.float(), v.float())
    torch.testing.assert_close(got, want, rtol=0, atol=BOUND)
    torch.testing.assert_close(got[0, 0, 0], torch.ones(d, device=cuda), rtol=0,
                               atol=1e-2)


def test_sd14_unet_forward_on_card(cuda):
    """sd-1-4's UNet at 512x512, batch 1, random weights: K1 5 launches at
    D = 80 and 5 at 160, K2 5 at 40, no other attention kernel, a finite
    output; float16 is refused at construction."""
    from gswm_torch.pipelines import InversablePipeline

    with pytest.raises(NotImplementedError, match="torch.float16"):
        InversablePipeline("sd-1-4", device=cuda, dtype=torch.float16)
    pipe = paths.build_pipeline("sd-1-4")
    inputs = paths.unet_inputs(pipe, 1, res=paths.RES_512)
    counters = ("fused_qkv_attention", "flash_attention", "flash_attention_split",
                "flash_attention_packed", "flash_attention_transposed")
    before = {n: dict(getattr(attn, n).launches_by_d) for n in counters}
    with torch.inference_mode():
        out = pipe.unet(*inputs)
    made = {n: {d: c - before[n].get(d, 0) for d, c in getattr(attn, n).launches_by_d.items()
                if c != before[n].get(d, 0)} for n in counters}
    assert made == {"fused_qkv_attention": {80: 5, 160: 5}, "flash_attention": {40: 5},
                    "flash_attention_split": {}, "flash_attention_packed": {},
                    "flash_attention_transposed": {}}
    assert out.shape == (1, 4, 64, 64) and torch.isfinite(out).all()


@pytest.mark.parametrize("s", [1, 65, 300, 1000])
@pytest.mark.parametrize("b,pairs", [(1, 1), (2, 3)])
def test_packed_kernel_matches_plain(cuda, b, pairs, s):
    """K6 at ragged lengths; the last head of each pair group zeroed, as the
    odd-head pad of the packed layout, must give zero output."""
    g = torch.Generator(device=cuda).manual_seed(s + pairs)
    qkv = torch.randn((b, s, 3 * pairs * 128), generator=g, device=cuda).bfloat16()
    for i in range(3):
        qkv[..., (i + 1) * pairs * 128 - 64:(i + 1) * pairs * 128] = 0
    before = attn.flash_attention_packed.launches
    got = attn.flash_attention_packed(qkv)
    assert attn.flash_attention_packed.launches == before + 1
    assert_attention_close(got, attn.flash_attention_packed_reference(qkv.float()))
    assert torch.equal(got[..., -64:], torch.zeros_like(got[..., -64:]))


@pytest.mark.parametrize("s", [1, 65, 300, 1001, 8, 72, 1000, 1024, 2056, 2120, 4096])
@pytest.mark.parametrize("b,h", [(1, 1), (2, 5)])
def test_transposed_kernel_matches_plain(cuda, b, h, s):
    """K7 at ragged lengths: S = 1, 65, 300 and 1001 are not multiples of 8,
    so their rows are not 16-byte aligned and no tensor map can address them
    (the same wgmma design, its boxes loaded and stored by hand); the others
    go through its tensor maps, with ragged last tiles of keys and of queries.  At (2, 5) and
    2056 or 2120 tokens an H100 takes 128-token blocks, whose second
    warpgroup's last tile lies wholly (2056) or partly (2120) past S."""
    g = torch.Generator(device=cuda).manual_seed(s + h)
    qkv_t = torch.randn((3 * h * 64, b, s), generator=g, device=cuda).bfloat16()
    before = attn.flash_attention_transposed.launches
    got = attn.flash_attention_transposed(qkv_t, h)
    assert attn.flash_attention_transposed.launches == before + 1
    assert_attention_close(got, attn.flash_attention_transposed_reference(
        qkv_t.float(), h))


@pytest.mark.parametrize("s", [136, 200])
def test_transposed_kernel_attends_to_the_chosen_key(cuda, s):
    """K7's 128-key tile is two 64-token panels, each its own wgmma operand:
    a wrong panel offset would read the wrong keys without any fault.  Query
    i is 4x the key (37 i + 5) % S, so its logits peak on that key alone
    (~32 against N(0, 16) for the rest) and the output must be that key's v
    row, within bf16 rounding of v (|v| < 8: 2^-6) and the rest's weight."""
    h, d = 2, 64
    g = torch.Generator(device=cuda).manual_seed(s)
    k = torch.randn((1, s, h, d), generator=g, device=cuda).bfloat16()
    v = torch.randn((1, s, h, d), generator=g, device=cuda).bfloat16()
    chosen = (37 * torch.arange(s, device=cuda) + 5) % s
    q = (4 * k[:, chosen].float()).bfloat16()
    qkv_t = torch.cat([t.permute(2, 3, 0, 1).reshape(h * d, 1, s) for t in (q, k, v)])
    qkv_t = qkv_t.contiguous()
    got = attn.flash_attention_transposed(qkv_t, h)
    assert_attention_close(got, attn.flash_attention_transposed_reference(
        qkv_t.float(), h))
    want = v[:, chosen].permute(2, 3, 0, 1).reshape(h * d, 1, s).float()
    torch.testing.assert_close(got.float(), want, rtol=0, atol=2**-5)


def test_transposed_kernel_tiles_do_not_cross_the_batch(cuda):
    """K7 at 1000 tokens (the wgmma + TMA kernel; not a multiple of its
    128-key or 64-token tiles): batch 1's k and v are 100x batch 0's, and in
    this layout batch 1's tokens follow batch 0's in every row, so a tile
    that read on would move batch 0's output by O(1) of its own scale."""
    b, s, h = 2, 1000, 3
    g = torch.Generator(device=cuda).manual_seed(13)
    qkv_t = torch.randn((3 * h * 64, b, s), generator=g, device=cuda)
    qkv_t[h * 64:, 1] *= 100
    qkv_t = qkv_t.bfloat16()
    got = attn.flash_attention_transposed(qkv_t, h).float()
    want = attn.flash_attention_transposed_reference(qkv_t.float(), h)
    assert_attention_close(got[:, 0], want[:, 0])
    err = (got[:, 1] - want[:, 1]).abs().max().item()
    assert err <= REL_BOUND * want[:, 1].abs().max().item()


def test_transposed_kernel_is_exact_softmax_above_60(cuda):
    """K7 with logits 80 and 70 in one row: exact softmax, where the TPU
    transposed kernel clamps both to 60 on every dtype."""
    s, d = 300, 64
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((1, s, 1, d), generator=g, device=cuda)
    k = torch.randn((1, s, 1, d), generator=g, device=cuda) * 0.1
    v = torch.randn((1, s, 1, d), generator=g, device=cuda)
    q[0, 0, 0] = 0.0
    q[0, 0, 0, 0], q[0, 0, 0, 1] = 80.0, 70.0
    k[0, 5, 0], k[0, 9, 0] = 0.0, 0.0
    k[0, 5, 0, 0], k[0, 9, 0, 1] = 8.0, 8.0
    v[0, 5, 0], v[0, 9, 0] = 1.0, -1.0
    qkv_t = torch.cat([t.permute(2, 3, 0, 1).reshape(d, 1, s) for t in (q, k, v)])
    qkv_t = qkv_t.bfloat16().contiguous()
    got = attn.flash_attention_transposed(qkv_t, 1).float()
    want = attn.flash_attention_transposed_reference(qkv_t.float(), 1)
    torch.testing.assert_close(got, want, rtol=0, atol=BOUND)
    torch.testing.assert_close(got[:, 0, 0], torch.ones(d, device=cuda), rtol=0,
                               atol=1e-2)


# K7's head dims off 64: every width of flash_hopper.cu's narrow kernel in
# the transposed layout (8 ... 48: rows past d zero-filled by the tensor map,
# p v at N = 48) and of flash_mid.cu's (72 ... 160: one or two full 64-row
# panels and a tail of 16, 32 or 48 rows), and the split kernel's 512-wide
# template (4 + 4 panels)
K7_HEAD_DIMS = (*range(8, 49, 8), *range(72, 161, 8), 512)
# the chosen key's logit stands sqrt(d) standard deviations of the others'
# above them, which over a thousand keys wins the softmax from d = 32 up
K7_CHOSEN_DIMS = tuple(d for d in K7_HEAD_DIMS if d >= 32)


def _to_transposed(*ts):
    """(B, S, H, D) q, k, v -> the (3 * H * D, B, S) stacked layout."""
    b, s, h, d = ts[0].shape
    return torch.cat([t.permute(2, 3, 0, 1).reshape(h * d, b, s) for t in ts]).contiguous()


def _heads(out_t, h):
    """(H * D, B, S) -> (B, S, H, D)."""
    n, b, s = out_t.shape
    return out_t.view(h, n // h, b, s).permute(2, 3, 0, 1)


@pytest.mark.parametrize("s", [136, 1001, 1024, 4096])
@pytest.mark.parametrize("d", K7_HEAD_DIMS)
def test_transposed_kernel_any_head_dim(cuda, d, s):
    """K7 at every kernel family: 136, 1024 and 4096 tokens through the
    wgmma + TMA kernels (the narrow one at d <= 48, the mid one at 64 < d <=
    160, the split one above; 136 leaves a ragged key and query tile; 1024
    and 4096 tokens take one and several consumer warpgroups a block), 1001
    through the same designs with their boxes loaded by hand; every head
    against the plain version, launches counted at the true d and by the
    kernel ``transposed_kernel`` names, and v = 1 shows the keys past S are
    masked."""
    b, h = 2, 3
    g = torch.Generator(device=cuda).manual_seed(s + d)
    qkv_t = torch.randn((3 * h * d, b, s), generator=g, device=cuda).bfloat16()
    kernel = attn.transposed_kernel(d, s)
    by_kernel = attn.flash_attention_transposed.launches_by_kernel
    before = attn.flash_attention_transposed.launches_by_d.get(d, 0), by_kernel.get(kernel, 0)
    got = attn.flash_attention_transposed(qkv_t, h)
    assert (attn.flash_attention_transposed.launches_by_d[d], by_kernel[kernel]) == \
        (before[0] + 1, before[1] + 1)
    assert got.shape == (h * d, b, s)
    want = attn.flash_attention_transposed_reference(qkv_t.float(), h)
    assert_every_head_close(_heads(got, h), _heads(want, h))
    qkv_t[2 * h * d:] = 1
    ones = attn.flash_attention_transposed(qkv_t, h).float()
    torch.testing.assert_close(ones, torch.ones_like(ones), rtol=0, atol=2**-7)


@pytest.mark.parametrize("d", K7_HEAD_DIMS)
def test_transposed_kernel_any_head_dim_tiles_do_not_cross_the_batch(cuda, d):
    """K7 off d = 64 at 1000 tokens (wgmma + TMA; ragged key and token
    tiles): batch 1's v is 100x batch 0's and follows batch 0's tokens in
    every row, so a tile that read on would move batch 0's output by O(1)
    of its own scale.  (Not k as at d = 64: logits of ~100 in batch 1 would
    turn the rounding of q d^-0.5 to bf16, exact only at d = 64, into
    O(1) changes of the softmax's weights.)"""
    b, s, h = 2, 1000, 2
    g = torch.Generator(device=cuda).manual_seed(d)
    qkv_t = torch.randn((3 * h * d, b, s), generator=g, device=cuda)
    qkv_t[2 * h * d:, 1] *= 100
    qkv_t = qkv_t.bfloat16()
    got = _heads(attn.flash_attention_transposed(qkv_t, h).float(), h)
    want = _heads(attn.flash_attention_transposed_reference(qkv_t.float(), h), h)
    assert_every_head_close(got[:1], want[:1])
    err = (got[1] - want[1]).abs().max().item()
    assert err <= REL_BOUND * want[1].abs().max().item()


@pytest.mark.parametrize("s", [136, 1001, 1024])
@pytest.mark.parametrize("d", K7_CHOSEN_DIMS)
def test_transposed_kernel_any_head_dim_attends_to_the_chosen_key(cuda, d, s):
    """Query i is 4x the key (37 i + 5) % S at d rows: a wrong row panel or
    a head read from its neighbour's rows would pick other keys without any
    fault.  Every key has norm d^0.5, so the logits peak on the chosen key
    (4 d^0.5, 25 at d = 40, against N(0, 16) for the rest), and the output
    is that key's v row within bf16 rounding."""
    h = 2
    g = torch.Generator(device=cuda).manual_seed(s + d)
    k = torch.randn((1, s, h, d), generator=g, device=cuda)
    k = (k * d**0.5 / k.norm(dim=-1, keepdim=True)).bfloat16()
    v = torch.randn((1, s, h, d), generator=g, device=cuda).bfloat16()
    chosen = (37 * torch.arange(s, device=cuda) + 5) % s
    q = (4 * k[:, chosen].float()).bfloat16()
    qkv_t = _to_transposed(q, k, v)
    got = attn.flash_attention_transposed(qkv_t, h)
    assert_attention_close(got, attn.flash_attention_transposed_reference(
        qkv_t.float(), h))
    torch.testing.assert_close(_heads(got, h).float(), v[:, chosen].float(), rtol=0,
                               atol=2**-5)


@pytest.mark.parametrize("s", [300, 1001])
@pytest.mark.parametrize("d", K7_HEAD_DIMS)
def test_transposed_kernel_is_exact_softmax_above_60_at_any_head_dim(cuda, d, s):
    """Logits 80 and 70 in one row at d != 64, where q is scaled by d^-0.5
    in shared memory (300 tokens: boxes by tensor maps; 1001: by hand):
    exact softmax, where the TPU transposed kernel clamps both to 60 on every
    dtype."""
    g = torch.Generator(device=cuda).manual_seed(d + s)
    q = torch.randn((1, s, 1, d), generator=g, device=cuda)
    k = torch.randn((1, s, 1, d), generator=g, device=cuda) * 0.1
    v = torch.randn((1, s, 1, d), generator=g, device=cuda)
    q[0, 0, 0] = 0.0
    q[0, 0, 0, 0], q[0, 0, 0, 1] = 80.0, 70.0
    k[0, 5, 0], k[0, 9, 0] = 0.0, 0.0
    k[0, 5, 0, 0], k[0, 9, 0, 1] = d**0.5, d**0.5  # logits ~80 and ~70
    v[0, 5, 0], v[0, 9, 0] = 1.0, -1.0
    qkv_t = _to_transposed(q, k, v).bfloat16()
    got = attn.flash_attention_transposed(qkv_t, 1).float()
    want = attn.flash_attention_transposed_reference(qkv_t.float(), 1)
    torch.testing.assert_close(got, want, rtol=0, atol=BOUND)
    torch.testing.assert_close(got[:, 0, 0], torch.ones(d, device=cuda), rtol=0,
                               atol=1e-2)


# K7's designs at a width each of their families: the narrow kernel's (8, 40,
# 48), the d = 64 kernel's (56, 64), flash_mid.cu's (72, 80, 160) and the
# split kernel's (192, 512)
K7_DESIGN_DIMS = (8, 40, 48, 56, 64, 72, 80, 160, 192, 512)


def _transposed_call(entry, qkv_t, out, h):
    """A K7 C entry on the card: ``gswm_flash_transposed`` or, every box by
    hand at any S, ``gswm_flash_transposed_rows``; out may be any view."""
    from gswm_torch import native

    n3, b, s = qkv_t.shape
    native.library().call(entry, qkv_t.data_ptr(), out.data_ptr(), b, s, h, n3 // (3 * h),
                          native.stream_handle(qkv_t.device))
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("b,s,h", [(2, 1024, 3), (1, 136, 2), (2, 4096, 5), (8, 256, 2)])
@pytest.mark.parametrize("d", K7_DESIGN_DIMS)
def test_hand_loaded_form_equals_the_tensor_maps_form(cuda, d, b, s, h):
    """Where S % 8 == 0 both forms of a design run: the boxes by tensor maps
    (gswm_flash_transposed) and by hand (gswm_flash_transposed_rows: cp.async
    copies into the same swizzled tiles, the output stored by hand).  The
    same tiles reach the same products, so the outputs are equal bit for
    bit: this holds the loads and stores apart from the arithmetic.  Above
    d = 160 the second form is the aligning pre-pass into scratch, then the
    tensor maps over it, the output by hand."""
    g = torch.Generator(device=cuda).manual_seed(d + s + b)
    qkv_t = torch.randn((3 * h * d, b, s), generator=g, device=cuda).bfloat16()
    out = qkv_t.new_empty((h * d, b, s))
    tma = _transposed_call("gswm_flash_transposed", qkv_t, out.clone(), h)
    rows = _transposed_call("gswm_flash_transposed_rows", qkv_t, out.clone(), h)
    assert torch.equal(rows, tma)
    assert torch.isfinite(rows.float()).all()


# K7's designs that are the natural layout's: flash_hopper.cu's narrow kernel
# and flash_mid.cu's kernel, at every width they take
NATURAL_DESIGN_DIMS = (*range(8, 49, 8), *range(72, 161, 8))


@pytest.mark.parametrize("s", [1, 65, 324, 988, 1001])
@pytest.mark.parametrize("d", NATURAL_DESIGN_DIMS)
def test_transposed_kernel_at_unaligned_s_equals_the_natural_kernel(cuda, d, s):
    """At S % 8 != 0 (1, 65 and 1001 odd; 324 and 988 the level-2 tokens of
    SD at 576x576 and of SDXL at 832x1216) K7 runs the narrow and mid designs
    with their boxes by hand: the same products in the same order as the
    natural layout's kernel on the same q, k and v, whose output it equals
    bit for bit; launches counted under the hand-loaded form's name."""
    b, h = 2, 3
    g = torch.Generator(device=cuda).manual_seed(d + s)
    qkv_t = torch.randn((3 * h * d, b, s), generator=g, device=cuda).bfloat16()
    kernel = attn.transposed_kernel(d, s)
    assert kernel == attn.head_dim_kernel(d, "transposed")[0] + attn.ROWS_FORM
    by_kernel = attn.flash_attention_transposed.launches_by_kernel
    before = by_kernel.get(kernel, 0)
    got = attn.flash_attention_transposed(qkv_t, h)
    assert by_kernel[kernel] == before + 1
    q, k, v = (t.permute(2, 3, 0, 1).reshape(b, s, h * d).contiguous()
               for t in qkv_t.view(3, h, d, b, s))
    natural = attn.flash_attention(q, k, v, h)
    assert torch.equal(_heads(got, h), natural.view(b, s, h, d))


@pytest.mark.parametrize("s", [1, 65, 324, 1001, 1024])
@pytest.mark.parametrize("d", K7_DESIGN_DIMS)
def test_transposed_kernel_writes_nothing_past_its_output(cuda, d, s):
    """The output as a view between two guard regions filled with a
    sentinel: the hand store writes tokens below S of rows below d alone (at
    S % 8 != 0 the chunks at a row's ends hold the next batch's tokens, and
    the last row's end the guard), so the guards come back intact and the
    output equals the wrapper's.  The view starts 16 bytes in, as the tensor
    maps at S % 8 == 0 need."""
    b, h = 3, 2
    g = torch.Generator(device=cuda).manual_seed(d * s)
    qkv_t = torch.randn((3 * h * d, b, s), generator=g, device=cuda).bfloat16()
    n, guard = h * d * b * s, 8 * 37
    sentinel = -12345.0  # exactly a bf16
    buf = torch.full((guard + n + guard,), sentinel, device=cuda, dtype=torch.bfloat16)
    out = buf[guard:guard + n].view(h * d, b, s)
    _transposed_call("gswm_flash_transposed", qkv_t, out, h)
    assert (buf[:guard] == sentinel).all() and (buf[guard + n:] == sentinel).all()
    assert torch.equal(out, attn.flash_attention_transposed(qkv_t, h))


# flash_hopper.cu's narrow kernel (d <= 48) at every width it takes, and 56,
# the first the d <= 64 kernel keeps
NARROW_HEAD_DIMS = (8, 16, 24, 32, 40, 48, 56)


@pytest.mark.parametrize("s", [1, 65, 577, 1001])
@pytest.mark.parametrize("d", NARROW_HEAD_DIMS)
def test_flash_kernel_narrow_head_dims(cuda, d, s):
    """K2 on natural-layout q/k/v at every narrow width: 1 token (one key,
    one query row), 65 (a ragged 128-key tile), 577 and 1001 (several tiles,
    the last ragged, which the pipelined kernel's last iteration takes
    alone); every head against the plain version; v = 1 shows the keys TMA
    zero-fills past S are masked."""
    b, h = 2, 8
    g = torch.Generator(device=cuda).manual_seed(s + d)
    q, k, v = (torch.randn((b, s, h * d), generator=g, device=cuda).bfloat16()
               for _ in range(3))
    before = attn.flash_attention.launches_by_d.get(d, 0)
    got = attn.flash_attention(q, k, v, h)
    assert attn.flash_attention.launches_by_d[d] == before + 1
    want = attn.flash_attention_reference(q.float(), k.float(), v.float(), h)
    assert_every_head_close(got.view(b, s, h, d), want.view(b, s, h, d))
    ones = attn.flash_attention(q, k, torch.ones_like(v), h).float()
    torch.testing.assert_close(ones, torch.ones_like(ones), rtol=0, atol=2**-7)


@pytest.mark.parametrize("sq,sk", [(1, 577), (65, 1001), (1001, 577)])
@pytest.mark.parametrize("d", NARROW_HEAD_DIMS)
def test_split_kernel_narrow_head_dims(cuda, d, sq, sk):
    """The same kernels through the split wrapper, Sq != Sk (512 keys and up
    take the kernel), with v = 1."""
    b, h = 2, 3
    g = torch.Generator(device=cuda).manual_seed(sq + sk + d)
    q = torch.randn((b, sq, h, d), generator=g, device=cuda).bfloat16()
    k, v = (torch.randn((b, sk, h, d), generator=g, device=cuda).bfloat16()
            for _ in range(2))
    before = attn.flash_attention_split.launches_by_d.get(d, 0)
    got = attn.flash_attention_split(q, k, v)
    assert attn.flash_attention_split.launches_by_d[d] == before + 1
    assert_every_head_close(got, attn.flash_attention_split_reference(
        q.float(), k.float(), v.float()))
    ones = attn.flash_attention_split(q, k, torch.ones_like(v)).float()
    torch.testing.assert_close(ones, torch.ones_like(ones), rtol=0, atol=2**-7)


# csrc/flash_mid.cu: every head dim it takes, 64 < d <= 160: one or two full
# 64-column panels and a tail of 0, 16, 32 or 48 columns
# (ops.attention.head_dim_kernel)
MID_HEAD_DIMS = tuple(range(72, 161, 8))


@pytest.mark.parametrize("sq,sk", [(1001, 1000), (1000, 1001), (65, 577), (1024, 1024)])
@pytest.mark.parametrize("d", MID_HEAD_DIMS)
def test_mid_kernel_matches_plain(cuda, d, sq, sk):
    """flash_mid_kernel through the split wrapper: ragged query and key
    tiles (1001 and 1000 rows are no multiple of the 64-row query tiles or
    of the 64- and 128-key tiles), Sq != Sk, every head against the plain
    version; v = 1 shows the keys TMA zero-fills past Sk are masked.  At
    batch 2 and 3 heads the grid takes one warpgroup a block; 8 heads at
    1024 take two (the natural-layout case below)."""
    b, h = 2, 3
    g = torch.Generator(device=cuda).manual_seed(sq + sk + d)
    q = torch.randn((b, sq, h, d), generator=g, device=cuda).bfloat16()
    k, v = (torch.randn((b, sk, h, d), generator=g, device=cuda).bfloat16()
            for _ in range(2))
    before = attn.flash_attention_split.launches_by_d.get(d, 0)
    got = attn.flash_attention_split(q, k, v)
    assert attn.flash_attention_split.launches_by_d[d] == before + 1
    assert_every_head_close(got, attn.flash_attention_split_reference(
        q.float(), k.float(), v.float()))
    ones = attn.flash_attention_split(q, k, torch.ones_like(v)).float()
    torch.testing.assert_close(ones, torch.ones_like(ones), rtol=0, atol=2**-7)


@pytest.mark.parametrize("s", [1001, 4096])
@pytest.mark.parametrize("d", MID_HEAD_DIMS)
def test_mid_kernel_natural_layout_two_warpgroups(cuda, d, s):
    """The natural-layout wrapper at 8 heads, batch 2: grids that fill the
    card, so blocks of two consumer warpgroups taking turns (and 128-key
    tiles where a row is two panels); 1001 tokens leave ragged tiles."""
    b, h = 2, 8
    g = torch.Generator(device=cuda).manual_seed(s + d)
    q, k, v = (torch.randn((b, s, h * d), generator=g, device=cuda).bfloat16()
               for _ in range(3))
    got = attn.flash_attention(q, k, v, h)
    want = attn.flash_attention_reference(q.float(), k.float(), v.float(), h)
    assert_every_head_close(got.view(b, s, h, d), want.view(b, s, h, d))


@pytest.mark.parametrize("sq,sk", [(1001, 1000), (1024, 1024)])
@pytest.mark.parametrize("d", MID_HEAD_DIMS)
def test_mid_kernel_lse_matches_plain(cuda, d, sq, sk):
    """flash_mid_kernel with its log-sum-exp output: lse within LSE_BOUND of
    the fp32 plain version, rows past Sq unwritten by the masked store, the
    output bit-equal to the kernel's without lse."""
    b, h = 2, 3
    g = torch.Generator(device=cuda).manual_seed(sq + sk + d + 1)
    q = torch.randn((b, sq, h, d), generator=g, device=cuda).bfloat16()
    k, v = (torch.randn((b, sk, h, d), generator=g, device=cuda).bfloat16()
            for _ in range(2))
    before = attn.flash_attention_split.lse_launches_by_d.get(d, 0)
    out, lse = attn.flash_attention_split(q, k, v, return_lse=True)
    assert attn.flash_attention_split.lse_launches_by_d[d] == before + 1
    want, want_lse = attn.flash_attention_split_lse_reference(q.float(), k.float(), v.float())
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    assert_every_head_close(out, want)
    assert (lse - want_lse).abs().max().item() <= LSE_BOUND
    assert torch.equal(out, attn.flash_attention_split(q, k, v))


@pytest.mark.parametrize("d", [72, 80, 128, 160])
def test_mid_kernel_is_exact_softmax_above_60(cuda, d):
    """Logits 80 and 70 in one row at widths of flash_mid_kernel, where
    d^-0.5 is no power of two and q is scaled in shared memory: exact
    softmax (weight ~1 on the 80 key), where the TPU no-max path would clamp
    both to 60; 640 keys are several tiles."""
    s = 640
    g = torch.Generator(device=cuda).manual_seed(d)
    q = torch.randn((1, s, 1, d), generator=g, device=cuda)
    k = torch.randn((1, s, 1, d), generator=g, device=cuda) * 0.1
    v = torch.randn((1, s, 1, d), generator=g, device=cuda)
    q[0, 0, 0] = 0.0
    q[0, 0, 0, 0], q[0, 0, 0, 1] = 80.0, 70.0
    k[0, 5, 0], k[0, 9, 0] = 0.0, 0.0
    k[0, 5, 0, 0], k[0, 9, 0, 1] = d**0.5, d**0.5  # logits ~80 and ~70
    v[0, 5, 0], v[0, 9, 0] = 1.0, -1.0
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got = attn.flash_attention_split(q, k, v).float()
    want = attn.flash_attention_split_reference(q.float(), k.float(), v.float())
    torch.testing.assert_close(got, want, rtol=0, atol=BOUND)
    torch.testing.assert_close(got[0, 0, 0], torch.ones(d, device=cuda), rtol=0,
                               atol=1e-2)


@pytest.mark.parametrize("d", [40, 64, 80, 128, 160, 192, 512])
def test_split_wrapper_reaches_the_kernel_of_its_head_dim(cuda, d):
    """One split call is one launch of the kernel ``head_dim_kernel`` names:
    flash_mid_kernel at 64 < d <= 160 and nothing else; d <= 64 and
    d > 160 reach their kernels as before (flash_hopper.cu's, and
    flash_split.cu's 192- and 512-wide templates)."""
    g = torch.Generator(device=cuda).manual_seed(d)
    q, k, v = (torch.randn((1, 600, 2, d), generator=g, device=cuda).bfloat16()
               for _ in range(3))
    kernel = attn.head_dim_kernel(d)[0]
    _assert_one_kernel_a_call(lambda: attn.flash_attention_split(q, k, v), kernel)
    _assert_one_kernel_a_call(lambda: attn.flash_attention_split(q, k, v, return_lse=True),
                              kernel)


@pytest.mark.parametrize("b,s,d", [(4, 1024, 80), (8, 1024, 80), (4, 256, 160),
                                   (8, 256, 160)])
def test_fused_qkv_core_is_the_mid_kernel_at_sd14_widths(cuda, b, s, d):
    """K1 at SD 1.x's levels 1 and 2: the GEMM, then flash_mid_kernel, and
    no other kernel (the profiler's device records of a window of calls)."""
    from torch.profiler import ProfilerActivity, profile

    h = 8
    c = h * d
    g = torch.Generator(device=cuda).manual_seed(b + s + d)
    x = torch.randn((b, s, c), generator=g, device=cuda).bfloat16()
    ws = [(torch.randn((h * d, c), generator=g, device=cuda) * c**-0.5).bfloat16()
          for _ in range(3)]
    attn.fused_qkv_attention(x, *ws, h)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.3)
        for _ in range(8):
            attn.fused_qkv_attention(x, *ws, h)
        torch.cuda.synchronize()
        time.sleep(0.05)
    kernels = {e.name for e in prof.events() if e.device_type.name == "CUDA"
               and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()}
    assert kernels and all("qkv_proj_kernel" in k or "flash_mid_kernel" in k
                           for k in kernels), kernels


@pytest.mark.parametrize("shape,eps,act", [
    ((2, 64, 1, 1), 1e-5, None), ((2, 64, 65, 1), 1e-6, "silu"),
    ((1, 320, 300, 1), 1e-5, "silu"), ((1, 128, 1000, 1), 1e-6, None),
    ((2, 640, 48, 48), 1e-5, "silu"), ((1, 128, 384, 384), 1e-6, "silu"),
    # one block a group; a cluster whose slices fit in shared memory, in each
    # block size; groups beyond 16 blocks' shared memory (a tail read twice)
    ((2, 1280, 12, 12), 1e-5, "silu"), ((2, 1280, 12, 12), 1e-5, None),
    ((2, 320, 96, 96), 1e-5, "silu"), ((1, 960, 96, 96), 1e-5, None),
    ((1, 512, 192, 192), 1e-6, "silu"), ((1, 256, 384, 384), 1e-6, None),
    ((1, 128, 768, 768), 1e-6, "silu"), ((1, 256, 768, 768), 1e-6, None),
    # groups of a megabyte and more at other batch sizes and group counts;
    # many channels a block's slice (H * W = 576, 1024 channels a group)
    ((1, 512, 192, 192), 1e-6, None), ((2, 128, 768, 768), 1e-6, "silu"),
    ((1, 256, 768, 768), 1e-6, "silu"), ((1, 32768, 24, 24), 1e-5, "silu"),
    ((3, 64, 512, 512), 1e-5, None),
    # H * W no multiple of 8: the element-wise instance, a cluster and a tail
    ((1, 128, 385, 385), 1e-6, "silu"), ((1, 32, 2001, 1001), 1e-5, None),
    ((3, 96, 7, 9), 1e-5, "silu")])
def test_group_norm_kernel_matches_plain(cuda, shape, eps, act):
    """K8 against its fp32 plain version: 0.02 and 1% of max |want| (one
    bf16 rounding of outputs below 8 is 2^-6 / 2)."""
    g = torch.Generator(device=cuda).manual_seed(shape[1] + shape[2])
    x = (torch.randn(shape, generator=g, device=cuda) * 2 + 0.5).bfloat16()
    w = 1 + 0.05 * torch.randn(shape[1], generator=g, device=cuda)
    b = 0.05 * torch.randn(shape[1], generator=g, device=cuda)
    before = gn.fused_group_norm.launches
    got = gn.fused_group_norm(x, w, b, 32, eps, act)
    assert gn.fused_group_norm.launches == before + 1
    want = gn.fused_group_norm_reference(x.float(), w, b, 32, eps, act)
    err = (got.float() - want).abs().max().item()
    assert err <= 0.02 and err <= 0.01 * want.abs().max().item()


def _assert_one_kernel_a_call(fn, kernel: str, calls: int = 8) -> None:
    """``calls`` calls of ``fn`` in one profiler window: exactly one launch
    record a call on the host's side of the trace, and on the device's no
    kernel but ``kernel`` (copies apart), at least one.  The count comes from
    the host's records: late in a process the tracer's mapping of the card's
    clock lags the host's and it drops device records as out of range."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.3)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    events = prof.events()
    launches = [e.name for e in events
                if e.device_type.name == "CPU" and "launch" in e.name.lower()]
    kernels = [e.name for e in events if e.device_type.name == "CUDA"
               and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
    assert len(launches) == calls, launches
    assert 0 < len(kernels) <= calls and all(kernel in k for k in kernels), kernels


def test_group_norm_kernel_is_one_launch_without_scratch_and_repeats(cuda):
    """One kernel a call, one allocation (the output) when the parameters are
    fp32 on the card, and the same bits on every run (no atomics)."""
    x = (torch.randn((2, 640, 96, 96), device=cuda) * 2 + 0.5).bfloat16()
    w, b = torch.rand(640, device=cuda) + 0.5, torch.randn(640, device=cuda)
    first = gn.fused_group_norm(x, w, b, 32, 1e-5, "silu")
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    again = gn.fused_group_norm(x, w, b, 32, 1e-5, "silu")
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == allocs + 1
    assert torch.equal(first, again)
    _assert_one_kernel_a_call(lambda: gn.fused_group_norm(x, w, b, 32, 1e-5, "silu"),
                              "gn_cluster_kernel")
    # bf16 parameters are converted (two more allocations), with the same result
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    ones = torch.ones(640, device=cuda)
    half = gn.fused_group_norm(x, ones.bfloat16(), b, 32, 1e-5, "silu")
    assert torch.equal(half, gn.fused_group_norm(x, ones, b, 32, 1e-5, "silu"))


def _group_norm_f64(x, w, b, groups, eps, act):
    """The JAX op's formulas in float64 over (B, C, ...) x of any layout."""
    shape = x.shape
    xd = x.double().reshape(shape[0], groups, -1)
    mean = xd.mean(dim=-1, keepdim=True)
    var = (xd.square().mean(dim=-1, keepdim=True) - mean.square()).clamp(min=0.0)
    bcast = (1, shape[1]) + (1,) * (len(shape) - 2)
    want = ((xd - mean) * torch.rsqrt(var + eps)).reshape(shape) * \
        w.double().reshape(bcast) + b.double().reshape(bcast)
    return want * torch.sigmoid(want) if act == "silu" else want


# channels-minor K8: (shape, groups, eps, act); cpg 10, 20, 40 (the UNet's),
# 4 (the VAE's), 3; ragged H * W; C * itemsize % 16 != 0 (the element-wise
# instance); the 768x768 VAE's largest images, a slab a round over the whole
# card, its tail read twice (no card keeps 75 MB), and slabs a grid round
# keeps whole or with their tails in L2; slabs a cluster keeps, in one round
# or several
NHWC_CASES = [
    ((2, 320, 96, 96), 32, 1e-5, "silu"), ((4, 640, 48, 48), 32, 1e-5, None),
    ((2, 1280, 12, 12), 32, 1e-5, "silu"), ((1, 96, 33, 17), 32, 1e-6, "silu"),
    ((3, 128, 7, 9), 32, 1e-6, None), ((2, 34, 10, 10), 2, 1e-5, "silu"),
    ((1, 38, 5, 3), 2, 1e-6, None), ((2, 512, 96, 96), 32, 1e-6, "silu"),
    ((1, 256, 384, 384), 32, 1e-6, None), ((1, 128, 768, 768), 32, 1e-6, "silu"),
    ((2, 128, 768, 768), 32, 1e-6, None), ((1, 320, 300, 1), 32, 1e-5, "silu"),
    # 2560 channels (the UNet's skip concatenations)
    ((2, 2560, 12, 12), 32, 1e-5, "silu"), ((4, 2560, 24, 24), 32, 1e-5, None),
    # a group's column no multiple of 16 bytes in bf16 (320 channels: 20
    # bytes) across images a cluster keeps whole; cpg = 1 (C = G)
    ((1, 320, 40, 40), 32, 1e-5, "silu"), ((2, 32, 24, 24), 32, 1e-5, "silu"),
    ((1, 96, 96, 96), 96, 1e-6, None),
    # the grid: slabs a round keeps whole, and more a round with their tails
    ((1, 512, 192, 192), 32, 1e-6, "silu"), ((2, 512, 192, 192), 32, 1e-6, None),
    # clusters over several rounds (256 slabs of 92 KB)
    ((16, 1280, 24, 24), 32, 1e-5, "silu"),
    # more than 4096 channels; groups of 520 bytes in bf16 (16-byte vectors
    # only in pairs: a column wider than a warp)
    ((2, 5120, 8, 8), 32, 1e-5, "silu"), ((1, 8320, 4, 4), 32, 1e-6, None)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("shape,groups,eps,act", NHWC_CASES)
def test_nhwc_group_norm_kernel_matches_plain(cuda, dtype, shape, groups, eps, act):
    """K8 on channels-last x: bf16 within 0.02 and 1% of max |want| of the
    fp32 plain version on the same x; float32 within 1e-5 of max |want| of
    the JAX op's formulas in float64; the output channels-last, in x's
    dtype, one launch on the channels-minor counter of x's dtype, and the
    same bits on a second call."""
    g = torch.Generator(device=cuda).manual_seed(shape[1] + shape[2] + groups)
    x = (torch.randn(shape, generator=g, device=cuda) * 2 + 0.5).to(dtype) \
        .contiguous(memory_format=torch.channels_last)
    w = 1 + 0.05 * torch.randn(shape[1], generator=g, device=cuda)
    b = 0.05 * torch.randn(shape[1], generator=g, device=cuda)
    names = ("launches", "launches_f32", "launches_nhwc", "launches_nhwc_f32")
    before = [getattr(gn.fused_group_norm, n) for n in names]
    got = gn.fused_group_norm(x, w, b, groups, eps, act)
    moved = [getattr(gn.fused_group_norm, n) - v for n, v in zip(names, before)]
    assert moved == ([0, 0, 1, 0] if dtype == torch.bfloat16 else [0, 0, 0, 1])
    assert got.dtype == dtype and got.shape == x.shape
    assert got.is_contiguous(memory_format=torch.channels_last) and \
        gn.layout_of(got) == gn.NHWC
    assert torch.equal(got, gn.fused_group_norm(x, w, b, groups, eps, act))
    if dtype == torch.bfloat16:
        want = gn.fused_group_norm_reference(x.float(), w, b, groups, eps, act)
        err = (got.float() - want).abs().max().item()
        assert err <= 0.02 and err <= 0.01 * want.abs().max().item(), err
    else:
        want = _group_norm_f64(x, w, b, groups, eps, act)
        err = (got.double() - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("shape", [(2, 640, 96, 96), (1, 128, 768, 768), (2, 34, 10, 10)])
def test_nhwc_group_norm_is_one_launch_one_allocation_and_repeats(cuda, dtype, shape):
    """Channels-last K8: one kernel a call (the slab kernel: clusters at
    (2, 640, 96, 96) and (2, 34, 10, 10), the grid at (1, 128, 768, 768)), one
    allocation (the output), and the same bits on a second call (the blocks'
    sums added in a fixed order)."""
    groups = 2 if shape[1] == 34 else 32
    x = (torch.randn(shape, device=cuda) * 2 + 0.5).to(dtype) \
        .contiguous(memory_format=torch.channels_last)
    w, b = torch.rand(shape[1], device=cuda) + 0.5, torch.randn(shape[1], device=cuda)
    first = gn.fused_group_norm(x, w, b, groups, 1e-5, "silu")
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    again = gn.fused_group_norm(x, w, b, groups, 1e-5, "silu")
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == allocs + 1
    assert torch.equal(first, again)
    _assert_one_kernel_a_call(lambda: gn.fused_group_norm(x, w, b, groups, 1e-5, "silu"),
                              "gn_slab_kernel")


@pytest.mark.parametrize("shape,act", [((1, 128, 768, 768), "silu"), ((1, 256, 768, 768), None),
                                       ((1, 512, 384, 384), "silu"), ((2, 128, 768, 768), None),
                                       ((2, 320, 96, 96), "silu"), ((4, 1280, 24, 24), None)])
def test_f32_group_norm_repeats_bit_for_bit(cuda, shape, act):
    """float32 NCHW K8 at the VAE's groups (4.7 to 18.9 MB: the persistent
    grid) and at the UNet's (the cluster kernel): the same output on a second
    call, within 1e-5 of max |want| of float64."""
    g = torch.Generator(device=cuda).manual_seed(shape[1] + shape[2] + 5)
    x = torch.randn(shape, generator=g, device=cuda) * 2 + 0.5
    w = 1 + 0.05 * torch.randn(shape[1], generator=g, device=cuda)
    b = 0.05 * torch.randn(shape[1], generator=g, device=cuda)
    first = gn.fused_group_norm(x, w, b, 32, 1e-6, act)
    assert torch.equal(first, gn.fused_group_norm(x, w, b, 32, 1e-6, act))
    want = _group_norm_f64(x, w, b, 32, 1e-6, act)
    err = (first.double() - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


# (shape, groups) pairs run on two streams at once: small images whose
# clusters take a few blocks each, so both are resident together; the slab
# edge cases (a 20-byte group column, cpg = 1, 2560 channels, several
# rounds of clusters, more than 4096 channels); the grid, a round and
# several, beside a cluster launch and beside itself
TWO_STREAM_PAIRS = [
    (((1, 320, 16, 16), 32), ((2, 256, 16, 16), 32)),
    (((1, 320, 40, 40), 32), ((2, 32, 24, 24), 32)),
    (((4, 2560, 24, 24), 32), ((16, 1280, 24, 24), 32)),
    (((2, 5120, 8, 8), 32), ((1, 38, 5, 3), 2)),
    (((1, 512, 192, 192), 32), ((2, 320, 96, 96), 32)),
    (((1, 128, 768, 768), 32), ((1, 512, 192, 192), 32))]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("pair", TWO_STREAM_PAIRS,
                         ids=lambda pair: "-".join(str(s[1]) for s, _ in pair))
def test_nhwc_group_norm_on_two_streams_at_once(cuda, dtype, pair):
    """Launches on two streams at once, each called many times on its own
    stream; every output equals that input's output on the default stream
    (a cluster's sums stay in its shared memory; each grid launch's sums and
    counters are its own)."""
    shapes = [s for s, _ in pair]
    groups = [gr for _, gr in pair]
    g = torch.Generator(device=cuda).manual_seed(24)
    xs = [(torch.randn(s, generator=g, device=cuda) * 2 + 0.5).to(dtype)
          .contiguous(memory_format=torch.channels_last) for s in shapes]
    ws = [1 + 0.05 * torch.randn(s[1], generator=g, device=cuda) for s in shapes]
    bs = [0.05 * torch.randn(s[1], generator=g, device=cuda) for s in shapes]
    want = [gn.fused_group_norm(x, w, b, gr, 1e-5, "silu")
            for x, w, b, gr in zip(xs, ws, bs, groups)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(device=cuda) for _ in shapes]
    calls = 64 if max(math.prod(s) for s in shapes) < 1 << 24 else 8
    outs = [[], []]
    for _ in range(calls):
        for k, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[k].append(gn.fused_group_norm(xs[k], ws[k], bs[k], groups[k], 1e-5,
                                                   "silu"))
    torch.cuda.synchronize()
    for k in range(len(shapes)):
        assert all(torch.equal(o, want[k]) for o in outs[k]), k


def test_group_norm_refuses_other_strides_on_the_card(cuda):
    """Neither contiguous nor channels-minor raises a ValueError naming the
    two layouts; channels-minor x whose groups are wider than a slab the
    kernel takes (8320 channels in one group) raises too; nothing is
    launched."""
    names = ("launches", "launches_f32", "launches_nhwc", "launches_nhwc_f32")
    before = [getattr(gn.fused_group_norm, n) for n in names]
    w, b = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    x = torch.zeros((2, 64, 8, 8), device=cuda, dtype=torch.bfloat16)
    for bad in (x[..., :4], x.transpose(2, 3), x[:, ::2]):
        if bad.is_contiguous():
            continue
        with pytest.raises(ValueError, match="contiguous.*channels-minor"):
            gn.fused_group_norm(bad, w, b)
    wide = torch.zeros((1, 8320, 2, 2), device=cuda, dtype=torch.bfloat16) \
        .contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="wider than"):
        gn.fused_group_norm(wide, torch.ones(8320, device=cuda), torch.zeros(8320, device=cuda),
                            groups=1)
    assert [getattr(gn.fused_group_norm, n) for n in names] == before


@pytest.mark.parametrize("rows,n_bits", [(1, 512), (4, 16384), (5, 2000), (3, 700),
                                         (7, 513), (300, 36864), (4096, 16384)])
def test_batch_keystream_kernel_bit_exact(cuda, rows, n_bits):
    """The batch kernel against its plain version and, row by row, against
    the single-key kernel; one row's counter carries into the high word, one
    wraps 2^64."""
    import numpy as np

    rng = np.random.default_rng(rows)
    keys = [rng.bytes(32) for _ in range(rows)]
    nonces = [rng.bytes(16) for _ in range(rows)]
    nonces[0] = (2**32 - 3).to_bytes(8, "little") + nonces[0][8:]
    nonces[-1] = (2**64 - 2).to_bytes(8, "little") + nonces[-1][8:]
    before = chacha.batch_keystream_bits.launches
    got = chacha.batch_keystream_bits(keys, nonces, n_bits, cuda)
    assert chacha.batch_keystream_bits.launches == before + 1
    assert got.dtype == torch.uint8 and got.shape == (rows, n_bits)
    some = range(rows) if rows <= 8 else (0, 1, rows // 2, rows - 1)
    for r in some:
        assert torch.equal(got[r], chacha.keystream_bits(keys[r], nonces[r], n_bits, cuda))
    sub = slice(0, min(rows, 64))
    want = chacha.batch_keystream_bits_reference(keys[sub], nonces[sub], n_bits, "cpu")
    assert torch.equal(got[sub].cpu(), want)
    want_bits = np.unpackbits(np.frombuffer(
        chacha.keystream_bytes_host(keys[0], nonces[0], -(-n_bits // 8)), np.uint8))
    assert np.array_equal(got[0].cpu().numpy(), want_bits[:n_bits])


def test_batch_keystream_is_one_kernel_and_no_wide_intermediate(cuda):
    """One kernel and one host-to-device copy a call; device memory grows by
    the bits and the 48-byte rows alone (no words, no int64 bits)."""
    import numpy as np

    rng = np.random.default_rng(0)
    rows, n_bits = 4096, 16384
    keys = [rng.bytes(32) for _ in range(rows)]
    nonces = [rng.bytes(16) for _ in range(rows)]
    chacha.batch_keystream_bits(keys[:2], nonces[:2], n_bits, cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    bits = chacha.batch_keystream_bits(keys, nonces, n_bits, cuda)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    assert grown <= rows * n_bits + rows * 48 + 2**20, grown
    _assert_one_kernel_a_call(lambda: chacha.batch_keystream_bits(keys, nonces, n_bits, cuda),
                              "chacha20_batch_kernel")
    assert bits.shape == (rows, n_bits)


def test_multikey_and_trace_on_card(cuda):
    """Per-user keys on the card: embed, decode, and both trace paths."""
    import numpy as np

    from gswm_torch import GSConfig
    from gswm_torch.core import multikey
    from gswm_torch.eval import trace

    rng = np.random.default_rng(5)
    n = 300
    keys = [rng.bytes(32) for _ in range(n)]
    nonces = [rng.bytes(16) for _ in range(n)]
    msgs = [rng.bytes(32) for _ in range(n)]
    cfg = GSConfig(message_bits=256)
    lat, msg = multikey.embed_latents_multikey(
        cfg, keys, nonces, msgs, generator=torch.Generator(cuda).manual_seed(1))
    assert lat.device.type == "cuda" and lat.shape == (n, 4, 64, 64)
    voted = multikey.recover_message_bits_multikey(lat, cfg, keys, nonces)
    want = torch.from_numpy(np.unpackbits(
        np.frombuffer(b"".join(msg), np.uint8)).reshape(n, 256)).to(cuda)
    assert torch.equal(voted, want)
    records = [{"key_hex": k.hex(), "nonce_hex": m.hex(), "message_hex": g.hex(),
                "message_length": 256} for k, m, g in zip(keys, nonces, msg)]
    before = chacha.batch_vote.launches, chacha.batch_keystream_bits.launches
    best, acc, accs = trace.find_source_device(lat[123], records, chunk=128)
    assert (chacha.batch_vote.launches, chacha.batch_keystream_bits.launches) == \
        (before[0] + 3, before[1])  # one vote launch a chunk, no keystream
    assert (best, acc) == (123, 1.0)
    assert trace.find_source(lat[123], records) == (best, acc, accs)
    packed = trace.pack_candidates(records)
    assert trace.find_source_device(lat[123], packed, chunk=128) == (best, acc, accs)
    assert trace.find_source_device(lat[123].cpu(), records, device="cpu") == (best, acc, accs)


VOTE_CASES = ([(*shape, True) for shape in paths.VOTE_SHAPES]
              + [(*shape, False) for shape in paths.VOTE_ROW_SHAPES]
              # odd lengths, a segment of more than 32 words, more message
              # bits than the latent has (no segment votes), 16 and 24 bit
              # planes of counts at few message bits, and rows that outgrow a
              # warp (a thread block a row)
              + [(3, 700, 96, True), (5, 513, 7, False), (3, 2048, 2048, True),
                 (3, 1024, 4096, True), (2, 70000, 3, False), (2, 131072, 1, True),
                 (2, 131072, 256, True), (3, 262144, 256, True), (3, 262144, 100, False),
                 (2, 262144, 8192, True)])


@pytest.mark.parametrize("rows,n_bits,mb,shared", VOTE_CASES)
def test_vote_kernel_bit_exact(cuda, rows, n_bits, mb, shared):
    """The vote kernel against its plain version on the card: scores equal
    as float32, voted bits equal; the rows that carry their message score
    1.0."""
    case = paths.vote_material(rows, n_bits, mb, shared, cuda)
    before = chacha.batch_vote.launches
    got = chacha.batch_vote(case.table, case.words, n_bits, mb, case.expected)
    bits = chacha.batch_vote(case.table, case.words, n_bits, mb)
    assert chacha.batch_vote.launches == before + 2
    assert got.dtype == torch.float32 and got.shape == (rows,)
    assert bits.dtype == torch.uint8 and bits.shape == (rows, mb)
    assert torch.equal(got, chacha.batch_vote_reference(case.table, case.words, n_bits, mb,
                                                        case.expected))
    assert torch.equal(bits, chacha.batch_vote_reference(case.table, case.words, n_bits, mb))
    if mb <= n_bits:
        assert (got[case.carriers] == 1.0).all()
        assert torch.equal(bits[case.carriers], case.message[case.carriers])


def test_vote_kernel_is_one_kernel_and_writes_no_keystream(cuda):
    """One kernel a call; device memory grows by the scores alone; material
    out of range raises before anything is launched; a row past the shared
    memory's 3584 blocks runs (the stream mode) and raises nothing."""
    n_bits, mb = 16384, 256
    case = paths.vote_material(4096, n_bits, mb, True, cuda)
    chacha.batch_vote(case.table, case.words, n_bits, mb, case.expected)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    chacha.batch_vote(case.table, case.words, n_bits, mb, case.expected)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= 4096 * 4 + 512
    _assert_one_kernel_a_call(
        lambda: chacha.batch_vote(case.table, case.words, n_bits, mb, case.expected),
        "chacha20_vote_kernel")
    before = chacha.batch_vote.launches
    big = chacha.VOTE_MAX_BLOCKS * chacha.BLOCK_BITS + 1
    zeros = torch.zeros((1, chacha.block_words(big)), dtype=torch.int32, device=cuda)
    assert chacha.batch_vote(case.table[:2], zeros, big, mb).shape == (2, mb)
    assert chacha.batch_vote.launches == before + 1
    before += 1
    with pytest.raises(ValueError, match="message bits"):
        chacha.batch_vote(case.table, case.words, n_bits, 2**24)
    offset = torch.zeros(case.words.numel() + 1, dtype=torch.int32, device=cuda)[1:]
    with pytest.raises(ValueError, match="aligned"):
        chacha.batch_vote(case.table, offset.view(1, -1), n_bits, mb)
    with pytest.raises(ValueError, match="devices"):
        chacha.batch_vote(case.table, case.words.cpu(), n_bits, mb)
    assert chacha.batch_vote.launches == before


def test_keystream_cache_launches_once_on_card(cuda):
    from gswm_torch import GSConfig, embed_latents, recover_message_bits
    from gswm_torch.core import embed

    embed.clear_caches()
    cfg = GSConfig(key_hex="ab" * 32, nonce_hex="cd" * 16, message="cache",
                   width=64, height=64, message_bits=32)
    before = chacha.keystream_words.launches
    for _ in range(2):
        zt, _ = embed_latents(cfg, generator=torch.Generator(cuda).manual_seed(1))
        recover_message_bits(zt, cfg)
    assert chacha.keystream_words.launches == before + 1


def test_new_kernel_wrappers_reject_what_they_do_not_take(cuda):
    with pytest.raises(TypeError):  # fp16
        attn.flash_attention_packed(torch.zeros((1, 8, 384), device=cuda).half())
    for d in (36, 520):  # D % 8 != 0, D > 512: K7 takes what the others take
        with pytest.raises(ValueError):
            attn.flash_attention_transposed(
                torch.zeros((3 * 2 * d, 1, 8), device=cuda, dtype=torch.bfloat16), 2)
    with pytest.raises(TypeError):
        gn.fused_group_norm(torch.zeros((1, 64, 4, 4), device=cuda).half(),
                            torch.ones(64, device=cuda), torch.zeros(64, device=cuda))
    xb = torch.zeros((1, 64, 4, 8), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # not contiguous
        gn.fused_group_norm(xb[..., :4], torch.ones(64, device=cuda),
                            torch.zeros(64, device=cuda))


@pytest.mark.parametrize("switches,wrapper", [
    ({"GSWM_XF_ATTN": "0"}, "flash_attention"),
    ({"GSWM_XF_ATTN": "0", "GSWM_CRES_ATTN": "0", "GSWM_PACKED_ATTN": "1"},
     "flash_attention_packed"),
    ({"GSWM_XF_ATTN": "0", "GSWM_CRES_ATTN": "0", "GSWM_TRANSPOSED_ATTN": "1"},
     "flash_attention_transposed"),
    ({"GSWM_FUSED_QKV": "0", "GSWM_XF_ATTN_MIN_SEQ": "99999",
      "GSWM_CRES_ATTN_MIN_SEQ": "99999"}, "flash_attention_split")])
def test_attention_tiers_agree_on_card(cuda, monkeypatch, switches, wrapper):
    """The UNet's level-0 self-attention (2, 2400 tokens, 320 channels, 5
    heads) under each switch set launches its tier's kernel once and gives
    the default route's output within 0.02 of |out| <= ~1 (bf16 rounding
    at different points of the projections)."""
    from gswm_torch.models import layers

    torch.manual_seed(0)
    mod = layers.Attention(320, 320, 5, 64).to(cuda, torch.bfloat16)
    x = torch.randn((2, 2400, 320), device=cuda).bfloat16()
    with torch.no_grad():
        want = mod(x).float()
        for name, value in switches.items():
            monkeypatch.setenv(name, value)
        fn = getattr(attn, wrapper)
        before = fn.launches
        got = mod(x).float()
    assert fn.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=BOUND)


def test_entry_points_default_to_the_card(cuda):
    """With no ``device`` the pipeline is built on, and the embedding and the
    keystream are returned on, the card."""
    from gswm_torch import GSConfig, embed_latents
    from gswm_torch.pipelines import InversablePipeline

    pipe = InversablePipeline("tiny")
    assert pipe.device.type == "cuda"
    assert {p.device.type for p in pipe.unet.parameters()} == {"cuda"}
    cfg = GSConfig(key_hex="22" * 32, nonce_hex="33" * 16, message="lthero",
                   width=64, height=64, message_bits=32)
    zt, _ = embed_latents(cfg)
    assert zt.device.type == "cuda"
    before = chacha.keystream_words.launches
    bits = chacha.keystream_bits(bytes(range(32)), bytes(16), 700)
    assert bits.device.type == "cuda" and bits.shape == (700,)
    assert chacha.keystream_words.launches == before + 1


def test_tiny_pipeline_closed_loop_on_card(cuda):
    """The pipeline on the card in bf16 (tiny preset: every attention is
    below the kernels' window, so only the keystream kernel runs)."""
    from gswm_torch import GSConfig, embed_latents, recover_message_bits
    from gswm_torch.pipelines import InversablePipeline

    from gswm_torch.core import embed

    pipe = InversablePipeline("tiny", device=cuda, dtype=torch.bfloat16)
    cfg = GSConfig(key_hex="22" * 32, nonce_hex="33" * 16, message="lthero",
                   width=64, height=64, message_bits=32)
    embed.clear_caches()
    before = chacha.keystream_words.launches
    zt, msg = embed_latents(cfg, generator=torch.Generator(cuda).manual_seed(1),
                            batch=2, device=cuda)
    z = pipe.invert(latents=pipe.generate(zt, guidance_scale=1.0, num_steps=8,
                                          decode=False), num_steps=8)
    bits = recover_message_bits(z, cfg)
    # embed and decode share one cached keystream
    assert chacha.keystream_words.launches == before + 1
    want = torch.tensor(list(msg), dtype=torch.uint8)
    want = ((want[:, None] >> torch.arange(7, -1, -1)) & 1).flatten().to(cuda)
    assert (bits == want).float().mean().item() >= 0.99


def test_tiny_xl_pipeline_closed_loop_on_card(cuda):
    """tiny-xl on the card in bf16: both text encoders and added_cond on
    the device, the closed loop at 0.99 or more."""
    from gswm_torch import GSConfig, embed_latents, recover_message_bits
    from gswm_torch.pipelines import InversablePipeline

    pipe = InversablePipeline("tiny-xl", device=cuda, dtype=torch.bfloat16)
    assert pipe.pooled_empty_text(2).device.type == "cuda"
    cfg = GSConfig(key_hex="22" * 32, nonce_hex="33" * 16, message="xl",
                   width=64, height=64, message_bits=32)
    zt, msg = embed_latents(cfg, generator=torch.Generator(cuda).manual_seed(1),
                            batch=2, device=cuda)
    ids = torch.randint(0, 999, (2, 77), generator=torch.Generator().manual_seed(2))
    images = pipe.generate(zt, prompt_ids=ids, num_steps=4)
    assert images.shape == (2, 3, 16, 16) and torch.isfinite(images).all()
    z = pipe.invert(latents=pipe.generate(zt, guidance_scale=1.0, num_steps=8,
                                          decode=False), num_steps=8)
    want = torch.tensor(list(msg), dtype=torch.uint8)
    want = ((want[:, None] >> torch.arange(7, -1, -1)) & 1).flatten().to(cuda)
    assert (recover_message_bits(z, cfg) == want).float().mean().item() >= 0.99


def test_sdxl_unet_forward_on_card(cuda):
    """sdxl-base's UNet at 1024x1024, batch 1, random weights: 60 K1 and 10
    K2 launches a forward, no other attention kernel, a finite output;
    float16 is refused at construction."""
    from gswm_torch.pipelines import InversablePipeline

    with pytest.raises(NotImplementedError, match="torch.float16"):
        InversablePipeline("sdxl-base", device=cuda, dtype=torch.float16)
    pipe = paths.build_pipeline("sdxl-base")
    inputs = paths.unet_inputs(pipe, 1, res=paths.RES_1024)
    counters = ("fused_qkv_attention", "flash_attention", "flash_attention_split",
                "flash_attention_packed", "flash_attention_transposed")
    before = {n: getattr(attn, n).launches for n in counters}
    with torch.inference_mode():
        out = pipe.unet(*inputs)
    made = {n: getattr(attn, n).launches - before[n] for n in counters}
    assert made == {"fused_qkv_attention": 60, "flash_attention": 10,
                    "flash_attention_split": 0, "flash_attention_packed": 0,
                    "flash_attention_transposed": 0}
    assert out.shape == (1, 4, 128, 128) and torch.isfinite(out).all()


@pytest.mark.parametrize("name", paths.attack_names())
def test_attack_on_card_matches_cpu(cuda, name):
    """Each batched attack at the 768x768 batch and relative strength 0.5: the
    card's output against the CPU's with the same draws, under the bounds of
    ``paths.attack_disagreement`` (1e-4; index-only attacks exact; the DCT JPEG
    by the share of pixels a quantisation step apart)."""
    x = paths.attack_images()
    strength = relative_strength_to_absolute(paths.ATTACK_REL_STRENGTH, name)
    draws = paths.attack_draws(name, x.shape)
    got = attacks.apply(x.to(cuda), name, strength, draws=paths.to_device(draws, cuda))
    assert got.device.type == "cuda"
    paths.attack_disagreement(name, got.cpu(), attacks.apply(x, name, strength, draws=draws))
    if name in attacks.RANDOMIZED:  # and from a generator on the card
        g = torch.Generator(device=cuda).manual_seed(1)
        drawn = attacks.apply(x.to(cuda), name, strength, generator=g)
        assert drawn.device.type == "cuda" and not torch.equal(drawn, got)


@pytest.mark.parametrize("via", [76, 230, 691, 1000])
def test_resize_cubic_on_card_matches_cpu(cuda, via):
    x = paths.attack_images()

    def round_trip(t):
        return attacks.resize_cubic(attacks.resize_cubic(t, (via, via + 3)), x.shape[-2:])

    paths.attack_disagreement("resize_cubic", round_trip(x.to(cuda)).cpu(), round_trip(x))


def test_tiny_sweep_and_treering_on_card(cuda):
    """The sweep's rows on the card agree with the CPU's on the tiny preset in
    float32 (below the kernels' window, so plain attention on both), and the
    Tree-Ring functions agree across the devices."""
    from gswm_torch import GSConfig, treering
    from gswm_torch.eval.sweep import run_sweep
    from gswm_torch.pipelines import InversablePipeline

    # 16x16 images: 64 tokens, below the kernels' window
    cfg = GSConfig(key_hex="22" * 32, nonce_hex="33" * 16, message="sweep", width=16,
                   height=16, vae_scale=2, message_bits=32)
    u = torch.rand((2, cfg.total_elements), generator=torch.Generator().manual_seed(3))
    rows = {}
    for dev in ("cpu", "cuda"):
        pipe = InversablePipeline("tiny", device=dev, dtype=torch.float32,
                                  generator=torch.Generator().manual_seed(0))
        rows[dev] = run_sweep(pipe, cfg, batch=2, num_steps=4, strengths=(0.04,),
                              draws={"u": u})
    assert [r.attack for r in rows["cuda"]] == [r.attack for r in rows["cpu"]]
    # a latent element within float32 rounding of 0 may turn a vote of 8
    # copies: two bits of 32 an image at most
    for got, want in zip(rows["cuda"], rows["cpu"]):
        if got.attack not in attacks.RANDOMIZED:
            assert max(abs(a - b) for a, b in zip(got.bit_accuracies,
                                                  want.bit_accuracies)) <= 2 / 32
    shape = (2, 4, 16, 16)
    base = torch.randn(shape, generator=torch.Generator().manual_seed(5))
    lat = torch.randn(shape, generator=torch.Generator().manual_seed(6))
    out = {}
    for dev in ("cpu", "cuda"):
        mask = treering.get_watermarking_mask(shape, 0, 4, device=dev)
        pattern = treering.get_watermarking_pattern(shape, "ring", 4, base=base, device=dev)
        marked = treering.inject_watermark(lat.to(dev), mask, pattern)
        out[dev] = (marked.cpu(), treering.eval_watermark(marked, pattern, mask).cpu(),
                    treering.get_p_value(marked, pattern, mask))
        assert marked.device.type == dev
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=0, atol=1e-4)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=0, atol=1e-4)
    assert max(out["cuda"][2]) < 0.01


def test_kernel_wrappers_refuse_a_gradient(cuda):
    """Every wrapper that writes a kernel's output raises under a gradient
    (no kernel has a backward; the VAE fit runs its attention chunked) and
    launches nothing; under no_grad the same call runs its kernel."""
    g = torch.Generator(device=cuda).manual_seed(7)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=cuda).bfloat16()

    x, w = rand(1, 256, 128), rand(128, 128) * 128**-0.5
    cases = {
        "flash_attention": (attn.flash_attention, lambda: (rand(1, 300, 128), rand(1, 300, 128),
                                                           rand(1, 300, 128), 2)),
        "flash_attention_split": (attn.flash_attention_split,
                                  lambda: (rand(1, 600, 1, 512), rand(1, 600, 1, 512),
                                           rand(1, 600, 1, 512))),
        "flash_attention_packed": (attn.flash_attention_packed, lambda: (rand(1, 300, 384),)),
        "flash_attention_transposed": (attn.flash_attention_transposed,
                                       lambda: (rand(3 * 128, 1, 256), 2)),
        "fused_qkv_attention": (attn.fused_qkv_attention, lambda: (x, w, w.clone(), w.clone(), 2)),
        "qkv_projection": (attn.qkv_projection, lambda: (x, w, w.clone(), w.clone())),
        "fused_group_norm": (gn.fused_group_norm,
                             lambda: (rand(1, 64, 8, 8), torch.ones(64, device=cuda),
                                      torch.zeros(64, device=cuda))),
    }
    for name, (fn, make) in cases.items():
        args = make()
        leaf = args[0].requires_grad_(True)
        before = fn.launches
        with pytest.raises(RuntimeError, match=f"{name}.*GSWM_VAE_ATTN=chunked"):
            fn(*args)
        assert fn.launches == before, name
        with torch.no_grad():
            fn(*args)
        torch.cuda.synchronize()
        assert fn.launches == before + 1, name
        assert leaf.requires_grad


# The log-sum-exp variant at its three epilogues: flash_hopper.cu's d <= 64
# kernel (64; 56 scales q in shared memory), its narrow kernel (40, 24) and
# flash_split.cu (80, 160, 512); query lengths off every block size, so the
# lse store's mask past Sq is read; bound: lse within 1e-2 of the fp32 plain
# version (the kernel sums bf16-rounded p, ~1e-3 relative)
LSE_BOUND = 1e-2


@pytest.mark.parametrize("b,sq,sk,h,d", [
    (2, 1000, 1300, 3, 64), (1, 4096, 4096, 5, 64), (1, 130, 577, 2, 56),
    (2, 700, 513, 2, 40), (4, 1024, 1024, 8, 40), (1, 65, 600, 3, 24),
    (1, 333, 900, 2, 80), (2, 100, 600, 2, 160), (1, 2048, 2048, 1, 512),
    (1, 1, 512, 1, 512)])
def test_flash_split_lse_kernel_matches_plain(cuda, b, sq, sk, h, d):
    g = torch.Generator(device=cuda).manual_seed(sq + d)
    q = torch.randn((b, sq, h, d), generator=g, device=cuda).bfloat16()
    k, v = (torch.randn((b, sk, h, d), generator=g, device=cuda).bfloat16() for _ in range(2))
    before = attn.flash_attention_split.lse_launches
    plain_before = attn.flash_attention_split.launches
    out, lse = attn.flash_attention_split(q, k, v, return_lse=True)
    assert attn.flash_attention_split.lse_launches == before + 1
    assert attn.flash_attention_split.launches == plain_before
    want, want_lse = attn.flash_attention_split_lse_reference(q.float(), k.float(), v.float())
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    assert_attention_close(out, want)
    assert (lse - want_lse).abs().max().item() <= LSE_BOUND
    # the output is the kernel's without lse, bit for bit
    assert torch.equal(out, attn.flash_attention_split(q, k, v))


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("b,s,h,d", [(2, 4096, 5, 64), (1, 2048, 8, 40), (1, 2048, 1, 512)])
def test_ring_steps_on_one_card_match_one_call(cuda, sp, b, s, h, d):
    """ring_attention's per-rank step for every virtual rank of an sp ring,
    in ring order (rank r holds k/v shard (r - step) % sp at a step): the
    folded output against one flash_attention_split call."""
    from gswm_torch.ops.ring_attention import ring_finish, ring_step

    g = torch.Generator(device=cuda).manual_seed(s + sp)
    q, k, v = (torch.randn((b, s, h, d), generator=g, device=cuda).bfloat16()
               for _ in range(3))
    qs, ks, vs = (t.chunk(sp, dim=1) for t in (q, k, v))
    outs = []
    for r in range(sp):
        acc = None
        for step in range(sp):
            src = (r - step) % sp
            acc = ring_step(qs[r].contiguous(), ks[src].contiguous(), vs[src].contiguous(), acc)
        outs.append(ring_finish(acc, q.dtype))
    got = torch.cat(outs, dim=1)
    want = attn.flash_attention_split_reference(q.float(), k.float(), v.float())
    assert_attention_close(got, want)


# ---- K7 above d = 160: flash_split.cu's kernel over the aligning pre-pass ----

SPLIT_K7_DIMS = (168, 192, 256, 512)


@pytest.mark.parametrize("s", [1, 13, 77, 324, 1001, 1024])
@pytest.mark.parametrize("d", SPLIT_K7_DIMS)
def test_split_k7_equals_the_natural_kernel_at_every_s(cuda, d, s):
    """K7 at d > 160 is flash_split.cu's kernel in the transposed layout, by
    tensor maps at S % 8 == 0 and over the pre-pass's scratch elsewhere: the
    same products in the same order as K4 on the same q, k and v, whose
    output it equals bit for bit; launches counted under the form's name,
    the pre-pass's on its own counter."""
    b, h = 2, 2
    g = torch.Generator(device=cuda).manual_seed(d + s)
    qkv_t = torch.randn((3 * h * d, b, s), generator=g, device=cuda).bfloat16()
    kernel = attn.transposed_kernel(d, s)
    assert kernel == "flash_split_kernel" + (attn.ALIGNED_FORM if s % 8 else "")
    by_kernel = attn.flash_attention_transposed.launches_by_kernel
    before = (by_kernel.get(kernel, 0), attn.flash_attention_transposed.align_launches)
    got = attn.flash_attention_transposed(qkv_t, h)
    assert (by_kernel[kernel], attn.flash_attention_transposed.align_launches) == \
        (before[0] + 1, before[1] + (s % 8 != 0))
    q, k, v = (t.permute(2, 3, 0, 1).reshape(b, s, h * d).contiguous()
               for t in qkv_t.view(3, h, d, b, s))
    natural = attn.flash_attention(q, k, v, h)
    assert torch.equal(_heads(got, h), natural.view(b, s, h, d))


@pytest.mark.parametrize("b,s,h,d", [(1, 1001, 1, 512), (2, 324, 2, 256), (1, 13, 3, 192),
                                     (2, 1024, 1, 512)])
def test_split_k7_prepass_and_entries_agree(cuda, b, s, h, d):
    """The pre-pass alone (``gswm_flash_transposed_align``) writes the input
    and zeros past S into scratch of the aligned pitch; K7 through its C
    entry (the pre-pass and the core from one call where S % 8 != 0),
    through ``gswm_flash_transposed_rows`` (the pre-pass form at any S) and
    through the wrapper, which makes that one C call and counts the
    pre-pass, equal bit for bit."""
    from gswm_torch import native

    lib, stream = native.library(), native.stream_handle(cuda)
    g = torch.Generator(device=cuda).manual_seed(b * s + d)
    qkv_t = torch.randn((3 * h * d, b, s), generator=g, device=cuda).bfloat16()
    pitch = attn.aligned_pitch(s)
    padded = torch.full((3 * h * d, b, pitch), 7.0, device=cuda, dtype=torch.bfloat16)
    lib.call("gswm_flash_transposed_align", qkv_t.data_ptr(), padded.data_ptr(),
             3 * h * d * b, s, pitch, stream)
    torch.cuda.synchronize()
    assert torch.equal(padded, attn.align_tokens_reference(qkv_t, pitch))
    out = torch.empty((h * d, b, s), device=cuda, dtype=torch.bfloat16)
    entry = _transposed_call("gswm_flash_transposed", qkv_t, out.clone(), h)
    rows = _transposed_call("gswm_flash_transposed_rows", qkv_t, out.clone(), h)
    before = attn.flash_attention_transposed.align_launches
    wrapper = attn.flash_attention_transposed(qkv_t, h)
    assert attn.flash_attention_transposed.align_launches == before + (s % 8 != 0)
    assert torch.equal(entry, rows) and torch.equal(entry, wrapper)
    assert torch.isfinite(entry.float()).all()


@pytest.mark.parametrize("s", [1001, 1024])
def test_split_k4_keeps_its_instance(cuda, s):
    """K4 and K4 with lse at d > 160 after the layout became a template
    parameter: each still equals the plain version within the attention
    bound, and K4 equals K4 + lse's output bit for bit (one kernel body,
    the lse store in its epilogue alone)."""
    b, h, d = 1, 2, 512
    g = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn((b, s, h, d), generator=g, device=cuda).bfloat16() for _ in range(3))
    got = attn.flash_attention_split(q, k, v)
    with_lse, lse = attn.flash_attention_split(q, k, v, return_lse=True)
    assert torch.equal(got, with_lse)
    assert_attention_close(got, attn.flash_attention_split_reference(q.float(), k.float(),
                                                                     v.float()))
    assert torch.isfinite(lse).all()


# ---- K3: the vote past 1,835,008 bits and the embed --------------------------

VOTE_STREAM_CASES = [
    (2, 2_097_152, 256, True), (3, 2_097_152, 256, False), (2, 1_835_009, 100, True),
    (2, 2_097_152, 9000, True), (2, 2_097_152, 1, False), (2, 4_194_304, 48, True),
    (2, 1_900_000, 2_000_000, True), (2, 2_000_003, 1_000_001, False)]


@pytest.mark.parametrize("rows,n_bits,mb,shared", VOTE_STREAM_CASES)
def test_vote_stream_mode_bit_exact(cuda, rows, n_bits, mb, shared):
    """Rows past 3584 blocks (a 2048x2048 latent at l = 8 is 2,097,152
    bits): the vote's stream mode against its plain version, scores equal as
    float32 and voted bits equal, at one latent for every row and a latent a
    row; message words past 256 (counted 256 at a time), one message bit
    (2M segments, 24 bit planes), more message bits than the row has (no
    segment votes) and one segment; carriers score 1.0."""
    assert chacha.vote_entry(n_bits) == chacha.VOTE_STREAM_ENTRY
    case = paths.vote_material(rows, n_bits, mb, shared, cuda)
    before = chacha.batch_vote.launches
    got = chacha.batch_vote(case.table, case.words, n_bits, mb, case.expected)
    bits = chacha.batch_vote(case.table, case.words, n_bits, mb)
    assert chacha.batch_vote.launches == before + 2
    assert torch.equal(got, chacha.batch_vote_reference(case.table, case.words, n_bits, mb,
                                                        case.expected))
    assert torch.equal(bits, chacha.batch_vote_reference(case.table, case.words, n_bits, mb))
    if mb <= n_bits:
        assert (got[case.carriers] == 1.0).all()
        assert torch.equal(bits[case.carriers], case.message[case.carriers])


def test_vote_stream_mode_is_one_kernel(cuda):
    n_bits, mb = 2_097_152, 256
    case = paths.vote_material(4, n_bits, mb, True, cuda)
    _assert_one_kernel_a_call(
        lambda: chacha.batch_vote(case.table, case.words, n_bits, mb, case.expected),
        "chacha20_vote_stream_kernel")


@pytest.mark.parametrize("splits", range(1, 9))
@pytest.mark.parametrize("rows,n_bits,mb,shared", [
    (2, 2_097_152, 256, True), (3, 2_097_152, 9000, False), (2, 2_000_003, 1, True),
    (2, 4_194_304, 48, False)])
def test_vote_stream_split_bit_exact(cuda, splits, rows, n_bits, mb, shared):
    """The stream mode's C entry at every cluster of 1 to 8 thread blocks a
    row (shares of the stream that end mid-segment, an odd share count, a
    message of 282 words counted 256 at a time, 24 bit planes): scores and
    voted bits equal the plain version's."""
    from gswm_torch import native

    case = paths.vote_material(rows, n_bits, mb, shared, cuda)
    scores = torch.empty(rows, dtype=torch.float32, device=cuda)
    voted = torch.empty((rows, mb), dtype=torch.uint8, device=cuda)
    for out, want in ((scores, case.expected), (voted, None)):
        native.library().call(chacha.VOTE_STREAM_ENTRY, case.table.data_ptr(),
                              case.words.data_ptr(), case.words.shape[0],
                              None if want is None else want.data_ptr(),
                              out.data_ptr() if want is not None else None,
                              out.data_ptr() if want is None else None, rows, n_bits, mb,
                              splits, native.stream_handle(cuda))
    torch.cuda.synchronize()
    assert torch.equal(scores, chacha.batch_vote_reference(case.table, case.words, n_bits, mb,
                                                           case.expected))
    assert torch.equal(voted, chacha.batch_vote_reference(case.table, case.words, n_bits, mb))


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The float32 ulps between a and b (same sign)."""
    ia, ib = a.view(torch.int32).long(), b.view(torch.int32).long()
    return (ia - ib).abs()


@pytest.mark.parametrize("l", [1, 2, 3, 7, 8])
@pytest.mark.parametrize("rows,elements", [(1, 16384), (5, 16384), (64, 4096), (3, 333)])
def test_embed_kernel_matches_plain(cuda, rows, elements, l):
    """The embed kernel against its plain version on the card, whose ndtri
    is torch.special.ndtri's: every quantized bit equal and z within 4
    float32 ulps or 1e-6 relative; one launch a call, counted."""
    from gswm_torch.core import decode

    rng = torch.Generator(device=cuda).manual_seed(rows + elements + l)
    keys, nonces, _, _ = paths.multikey_material(rows, seed=l)
    nonces[0] = (2**32 - 2).to_bytes(8, "little") + nonces[0][8:]
    table = torch.from_numpy(chacha.key_table(keys, nonces).view("int32")).to(cuda)
    n_bits = elements * l
    bits = torch.randint(0, 2, (rows, n_bits), generator=rng, device=cuda, dtype=torch.uint8)
    words = chacha.pack_bits(bits, chacha.block_words(n_bits))
    u = torch.rand((rows, elements), generator=rng, device=cuda)
    before = chacha.batch_embed.launches
    got = chacha.batch_embed(table, words, u, l)
    assert chacha.batch_embed.launches == before + 1
    want = chacha.batch_embed_reference(table, words, u, l)
    assert got.shape == want.shape == (rows, elements) and got.dtype == torch.float32
    assert torch.equal(decode.quantize_latent_bits(got.view(rows, 1, 1, elements), l),
                       decode.quantize_latent_bits(want.view(rows, 1, 1, elements), l))
    close = (_ulps(got, want) <= 4) | ((got - want).abs() <= 1e-6 * want.abs())
    assert close.all(), (got - want).abs().max().item()


def test_multikey_embed_is_one_embed_launch(cuda):
    """``embed_latents_multikey`` on the card: one launch of the embed
    kernel a call and none of the table kernel; its rows decode to their
    messages at 1.0."""
    from gswm_torch import GSConfig
    from gswm_torch.core import multikey

    cfg = GSConfig(width=512, height=512, message_bits=256)
    keys, nonces, msgs, _ = paths.multikey_material(64, seed=3)
    before = (chacha.batch_embed.launches, chacha.batch_keystream_bits.launches)
    lat, msg = multikey.embed_latents_multikey(cfg, keys, nonces, msgs, device=cuda,
                                               generator=torch.Generator(cuda).manual_seed(0))
    assert (chacha.batch_embed.launches, chacha.batch_keystream_bits.launches) == \
        (before[0] + 1, before[1])
    voted = multikey.recover_message_bits_multikey(lat, cfg, keys, nonces)
    want = torch.tensor([list(map(int, "".join(f"{x:08b}" for x in m))) for m in msg],
                        dtype=torch.uint8)
    assert torch.equal(voted.cpu(), want[:, :256])
    u = torch.rand((64, cfg.total_elements), device=cuda)
    _assert_one_kernel_a_call(
        lambda: multikey.embed_latents_multikey(cfg, keys, nonces, msgs, u=u, device=cuda),
        "chacha20_embed_kernel", calls=4)
