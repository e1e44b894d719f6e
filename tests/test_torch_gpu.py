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

import time

import pytest
import torch
import torch.nn.functional as F

from gswm_torch.core import chacha
from gswm_torch.distortions import device as attacks
from gswm_torch.distortions import relative_strength_to_absolute
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
    """K4 at D = 64, 128, 192 (an odd panel count: the consumers own 2 + 1)
    and 512: short query lengths, ragged key tails (577 and 1000 keys are not
    multiples of the 64-key tile) and the VAE's 9216."""
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
    """K4 at every width its launcher instantiates: the ring is 4 stages deep
    at D <= 192, 3 at 256, 2 at 320 and a single k and v buffer from 384 up,
    and the consumers own equal panel counts or one more and one fewer; 700
    keys are 11 tiles, so every ring wraps, and the last tile is ragged."""
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
        attn.fused_qkv_attention(x, w, w, w, 2)  # fp32
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
        attn.flash_attention_split(q4, q4, q4)  # fp32
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


# Head dims other than 64: flash_hopper.cu below (8, 40), flash_split.cu's
# 128-wide kernel (72, 80: one whole panel and one of 8 or 16 real columns),
# its 192-wide one (160: 2 + 1 panels, the third half zeros)
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
    output; fp32 is refused at construction."""
    from gswm_torch.pipelines import InversablePipeline

    with pytest.raises(NotImplementedError, match="bfloat16 only"):
        InversablePipeline("sd-1-4", device=cuda, dtype=torch.float32)
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
    (the masked element-wise kernel); the others go through the wgmma + TMA
    kernel, with ragged last tiles of keys and of queries.  At (2, 5) and
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


# K7's head dims off 64: below (8, 40: rows past d zero-filled by the tensor
# map), the split kernel's 128-wide (72, 80), 192-wide (160: 2 + 1 panels)
# and 512-wide (4 + 4 panels) templates
K7_HEAD_DIMS = (8, 40, 72, 80, 160, 512)


def _to_transposed(*ts):
    """(B, S, H, D) q, k, v -> the (3 * H * D, B, S) stacked layout."""
    b, s, h, d = ts[0].shape
    return torch.cat([t.permute(2, 3, 0, 1).reshape(h * d, b, s) for t in ts]).contiguous()


def _heads(out_t, h):
    """(H * D, B, S) -> (B, S, H, D)."""
    n, b, s = out_t.shape
    return out_t.view(h, n // h, b, s).permute(2, 3, 0, 1)


@pytest.mark.parametrize("s", [136, 1001, 4096])
@pytest.mark.parametrize("d", K7_HEAD_DIMS)
def test_transposed_kernel_any_head_dim(cuda, d, s):
    """K7 at every kernel family: 136 and 4096 tokens through the wgmma +
    TMA kernels (d <= 64 one, the split one above; 136 leaves a ragged key
    and query tile), 1001 through the masked one, which walks d in 64-row
    panels; every head against the plain version, launches counted at the
    true d, and v = 1 shows the keys past S are masked."""
    b, h = 2, 3
    g = torch.Generator(device=cuda).manual_seed(s + d)
    qkv_t = torch.randn((3 * h * d, b, s), generator=g, device=cuda).bfloat16()
    before = attn.flash_attention_transposed.launches_by_d.get(d, 0)
    got = attn.flash_attention_transposed(qkv_t, h)
    assert attn.flash_attention_transposed.launches_by_d[d] == before + 1
    assert got.shape == (h * d, b, s)
    want = attn.flash_attention_transposed_reference(qkv_t.float(), h)
    assert_every_head_close(_heads(got, h), _heads(want, h))
    qkv_t[2 * h * d:] = 1
    ones = attn.flash_attention_transposed(qkv_t, h).float()
    torch.testing.assert_close(ones, torch.ones_like(ones), rtol=0, atol=2**-7)


@pytest.mark.parametrize("d", [40, 160, 512])
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


@pytest.mark.parametrize("s", [136, 1001])
@pytest.mark.parametrize("d", [40, 80, 160, 512])
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
@pytest.mark.parametrize("d", [40, 160])
def test_transposed_kernel_is_exact_softmax_above_60_at_any_head_dim(cuda, d, s):
    """Logits 80 and 70 in one row at d != 64, where q is scaled by d^-0.5
    in shared memory (300 tokens: wgmma + TMA) or by the masked kernel
    (1001): exact softmax, where the TPU transposed kernel clamps both to 60
    on every dtype."""
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
    before = chacha.batch_keystream_bits.launches
    best, acc, accs = trace.find_source_device(lat[123], records, chunk=128)
    assert chacha.batch_keystream_bits.launches == before + 3
    assert (best, acc) == (123, 1.0)
    assert trace.find_source(lat[123], records) == (best, acc, accs)


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
    with pytest.raises(TypeError):
        attn.flash_attention_packed(torch.zeros((1, 8, 384), device=cuda))  # fp32
    for d in (36, 520):  # D % 8 != 0, D > 512: K7 takes what the others take
        with pytest.raises(ValueError):
            attn.flash_attention_transposed(
                torch.zeros((3 * 2 * d, 1, 8), device=cuda, dtype=torch.bfloat16), 2)
    with pytest.raises(TypeError):
        gn.fused_group_norm(torch.zeros((1, 64, 4, 4), device=cuda),
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
    K2 launches a forward, no other attention kernel, a finite output; fp32
    is refused at construction."""
    from gswm_torch.pipelines import InversablePipeline

    with pytest.raises(NotImplementedError, match="bfloat16 only"):
        InversablePipeline("sdxl-base", device=cuda, dtype=torch.float32)
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
