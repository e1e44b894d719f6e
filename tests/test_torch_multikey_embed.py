"""K3's table ending in the multikey embed, and the vote past 1,835,008 bits
a row, on the CPU.

The embed kernel (csrc/chacha20.cu chacha20_embed_kernel, ``chacha.
batch_embed``) has a plain version, ``chacha.batch_embed_reference``: the
keystream words XOR the payload words packed by ``_table_and_payload``,
unpacked, windowed, clamped and mapped by ndtri.  Here it is held to the JAX
package's ``embed_latents_multikey`` at the same uniforms (jax.random's,
handed to the port), at l = 1, 2, 3 and 8 and 1, 4 and 16 rows: latents
within 1e-6 relative of the larger magnitude or 1e-6 absolute (the two
libraries' ndtri round differently in the last bits), quantized bits equal
on every element.  The vote's stream mode is reached past VOTE_MAX_BLOCKS
blocks a row (a recorder in place of the library), and the JAX package's
``recover_message_bits_multikey`` at 2,097,152 bits a row (a 2048x2048
image at l = 8) equals the port's plain path.  The kernels themselves are
held to these plain versions on the card (tests/test_torch_gpu.py,
chip_smoke.py phases 2 and 7).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gswm.config import GSConfig as JGSConfig
from gswm.core import multikey as jmk
from gswm_torch import native, roofline
from gswm_torch.config import GSConfig
from gswm_torch.core import bits as bitops
from gswm_torch.core import chacha, decode, multikey
from gswm_torch.core.embed import _bits_to_latent

torch.set_num_threads(2)

# counter low word 2^32 - 3: the 64-bit block counter carries at block 3
CARRY = (2**32 - 3).to_bytes(8, "little")
REL = 1e-6
STREAM = 0x5EED
SMS = 132  # an H100 SXM's


def _material(n, seed):
    rng = np.random.default_rng(seed)
    keys = [rng.bytes(32) for _ in range(n)]
    nonces = [rng.bytes(16) for _ in range(n)]
    msgs = [rng.bytes(32) for _ in range(n)]
    nonces[0] = CARRY + nonces[0][8:]
    return keys, nonces, msgs


def _cfgs(l, size=64, bits=256):
    kw = dict(key_hex="22" * 32, nonce_hex="33" * 16, message="x", width=size, height=size,
              l=l, message_bits=bits)
    return JGSConfig(**kw), GSConfig(**kw)


@pytest.mark.parametrize("b", [1, 4, 16])
@pytest.mark.parametrize("l", [1, 2, 3, 8])
def test_embed_plain_model_matches_jax_at_the_same_u(l, b):
    """The port's multikey embed on the CPU (the embed kernel's plain model:
    payload packing, windows, clamp, ndtri) against JAX's
    ``embed_latents_multikey`` with its uniforms: latents within 1e-6
    relative, quantized bits equal, and each row decodes its message."""
    jcfg, cfg = _cfgs(l)
    keys, nonces, msgs = _material(b, seed=10 * l + b)
    rng = jax.random.key(l + 7 * b)
    jlat, jmsg = jmk.embed_latents_multikey(jcfg, keys, nonces, msgs, rng=rng)
    u = np.array(jax.random.uniform(rng, (b, cfg.total_elements), dtype=jnp.float32))
    before = chacha.batch_embed.launches
    lat, msg = multikey.embed_latents_multikey(cfg, keys, nonces, msgs, u=u, device="cpu")
    assert chacha.batch_embed.launches == before  # CPU: the plain version
    assert msg == jmsg and lat.dtype == torch.float32
    want = np.array(jlat)
    assert lat.shape == want.shape == (b, 4, 8, 8)
    got = lat.numpy()
    np.testing.assert_allclose(got, want, rtol=REL, atol=REL)
    np.testing.assert_array_equal(
        decode.quantize_latent_bits(lat, l).numpy(),
        decode.quantize_latent_bits(torch.from_numpy(want), l).numpy())
    voted = multikey.recover_message_bits_multikey(lat, cfg, keys, nonces)
    want_bits = np.unpackbits(np.frombuffer(b"".join(msg), np.uint8)).reshape(b, -1)
    np.testing.assert_array_equal(voted.numpy(), want_bits[:, :cfg.resolved_message_bits])


def _payload(msgs, n_bits):
    """The diffused payload bits of each message, as the parent's embed made
    them."""
    return np.stack([bitops.diffuse_payload(bitops.bytes_to_bits(m), n_bits) for m in msgs])


@pytest.mark.parametrize("l", [1, 3, 8])
def test_batch_embed_reference_is_the_parents_path_bit_for_bit(l):
    """``batch_embed_reference`` on the packed payload equals the path it
    replaces (the table's keystream bits XOR the diffused payload's bits,
    then ``_bits_to_latent``) bit for bit, at a row length no multiple of
    32 and messages of 5 bytes (a zero-filled remainder)."""
    elements = 333
    n_bits = elements * l
    keys, nonces, msgs = _material(3, seed=l)
    msgs = [m[:5] for m in msgs]
    rng = np.random.default_rng(l)
    u = torch.from_numpy(rng.random((3, elements), dtype=np.float32))
    table, words = multikey._table_and_payload(keys, nonces, msgs, n_bits, "cpu")
    got = chacha.batch_embed(table, words, u, l)
    cipher = chacha.batch_keystream_bits_reference(keys, nonces, n_bits, "cpu") ^ \
        torch.from_numpy(_payload(msgs, n_bits))
    want = _bits_to_latent(cipher.reshape(-1), u.reshape(-1), l, (3, elements))
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_bits", [1000, 1024, 16384, 700])
def test_table_and_payload_is_one_buffer_packed_as_pack_bits(n_bits):
    """The key table and the packed payload are views of one buffer (one
    host-to-device copy on the card), the payload words 16-byte aligned and
    equal to ``chacha.pack_bits`` of the diffused payload's bits."""
    keys, nonces, msgs = _material(5, seed=3)
    msgs = [m[:7] for m in msgs]
    table, words = multikey._table_and_payload(keys, nonces, msgs, n_bits, "cpu")
    assert table.untyped_storage().data_ptr() == words.untyped_storage().data_ptr()
    assert (words.data_ptr() - table.data_ptr()) % 16 == 0
    assert table.is_contiguous() and words.is_contiguous()
    assert torch.equal(table, torch.from_numpy(chacha.key_table(keys, nonces).view(np.int32)))
    assert torch.equal(words, chacha.pack_bits(torch.from_numpy(_payload(msgs, n_bits)),
                                               chacha.block_words(n_bits)))


def test_batch_embed_rejects_bad_arguments():
    table = torch.zeros((2, 12), dtype=torch.int32)
    words = torch.zeros((2, 16), dtype=torch.int32)
    u = torch.zeros((2, 100), dtype=torch.float32)
    for args in ((table, words, u, 0), (table, words, u, 9), (table[:1], words, u, 1),
                 (table, words[:, :8], u, 1), (table, words, u.double(), 1),
                 (table.long(), words, u, 1)):
        with pytest.raises(ValueError):
            chacha.batch_embed(*args)


def test_embed_bound_counts_the_bytes_of_u_z_and_the_payload():
    """``roofline.chacha_embed_cost``: 640 XORs and rotations a block
    against u read and z written (8 bytes an element), 64 bytes of packed
    payload a block and 48 of key a row; the bytes bind."""
    ops, nbytes = roofline.chacha_embed_cost(10000, 16384, 1)
    assert ops == 10000 * 32 * 640
    assert nbytes == 10000 * (8 * 16384 + 64 * 32 + 48)
    ms, roof = roofline.bound_ms(ops, nbytes, roofline.PEAK_INT32)
    assert roof == "bytes" and ms == pytest.approx(1e3 * nbytes / roofline.PEAK_BYTES)
    assert roofline.chacha_embed_cost(1, 333, 3) == (2 * 640, 8 * 333 + 64 * 2 + 48)


# ---- the vote's mode past VOTE_MAX_BLOCKS, on a recorder --------------------

class _OnCard:
    """Stands in for a contiguous, 16-byte aligned int32 tensor on a card."""

    device = torch.device("cuda", 0)

    def __init__(self, shape, dtype, address):
        shape = (shape,) if isinstance(shape, int) else shape
        self.shape, self.dtype, self.address = torch.Size(shape), dtype, address

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return self.address


class _Recorder:
    def __init__(self):
        self.calls = []

    def call(self, name, *args):
        self.calls.append((name, args))


@pytest.fixture
def card(monkeypatch):
    lib = _Recorder()
    made = iter(range(0x100000, 1 << 40, 0x100000))
    monkeypatch.setattr(native, "launch", lambda device, name, *args: lib.call(
        name, *args, STREAM))
    monkeypatch.setattr(torch, "empty", lambda shape, dtype=None, device=None: _OnCard(
        shape, dtype, next(made)))

    def trap(*args, **kwargs):
        raise AssertionError("a plain version ran on a CUDA tensor")

    monkeypatch.setattr(chacha, "batch_vote_reference", trap)
    monkeypatch.setattr(chacha, "_multiprocessors", lambda device: SMS)
    return lib


@pytest.mark.parametrize("n_bits,entry", [
    (16384, "gswm_chacha20_vote"), (1_835_008, "gswm_chacha20_vote"),
    (1_835_009, "gswm_chacha20_vote_stream"), (2_097_152, "gswm_chacha20_vote_stream"),
    (50_000_000, "gswm_chacha20_vote_stream")])
@pytest.mark.parametrize("scores", [True, False], ids=["scores", "voted"])
def test_vote_takes_its_stream_mode_past_the_old_limit(card, n_bits, entry, scores):
    """``batch_vote`` on the card: to 3584 blocks a row the vote kernel's
    entry, past them its stream mode's (``vote_entry``), with the same
    arguments and ``vote_splits``' thread blocks a row (132 SMs: 8 at 3
    rows); one launch a call,
    counted; no ValueError below the index limit."""
    rows, mb = 3, 256
    table = _OnCard((rows, 12), torch.int32, 0x10)
    latent = _OnCard((1, chacha.block_words(n_bits)), torch.int32, 0x20)
    expected = _OnCard((rows, 8), torch.int32, 0x30) if scores else None
    assert chacha.vote_entry(n_bits) == entry
    before = chacha.batch_vote.launches
    out = chacha.batch_vote(table, latent, n_bits, mb, expected)
    assert chacha.batch_vote.launches == before + 1
    assert out.shape == ((rows,) if scores else (rows, mb))
    assert out.dtype == (torch.float32 if scores else torch.uint8)
    assert card.calls == [(entry, (0x10, 0x20, 1, 0x30 if scores else None,
                                   out.data_ptr() if scores else None,
                                   None if scores else out.data_ptr(),
                                   rows, n_bits, mb,
                                   *((8,) if entry.endswith("_stream") else ()), STREAM))]


@pytest.mark.parametrize("rows,splits", [(1, 8), (2, 8), (16, 8), (17, 4), (33, 4), (34, 2), (64, 2),
                                         (66, 2), (67, 1), (132, 1), (512, 1), (10000, 1)])
def test_vote_splits_by_row_count(rows, splits):
    """The stream mode's thread blocks a row on a card of 132 SMs: as many
    as keep rows * splits within the SM count, a power of two to
    ``VOTE_MAX_SPLITS``, one past half the SM count; the C entry's limit is
    the same 8 (csrc/chacha20.cu STREAM_MAX_SPLITS)."""
    assert chacha.vote_splits(rows, SMS) == splits
    assert chacha.vote_splits(1, 4) == 4 and chacha.vote_splits(3, 4) == 1
    assert chacha.VOTE_MAX_SPLITS == 8
    source = (Path(chacha.__file__).resolve().parents[1] / "csrc" / "chacha20.cu").read_text()
    assert f"constexpr int STREAM_MAX_SPLITS = {chacha.VOTE_MAX_SPLITS};" in source


def test_vote_refuses_only_past_the_index_limit(card):
    """rows * blocks must stay below 2^31, as ``batch_keystream_bits``
    keeps it: the one ValueError of the row length left on the card."""
    n_bits = 2**20 * 512
    table = _OnCard((2048, 12), torch.int32, 0x10)
    latent = _OnCard((1, chacha.block_words(n_bits)), torch.int32, 0x20)
    with pytest.raises(ValueError, match="out of range"):
        chacha.batch_vote(table, latent, n_bits, 256)
    assert not card.calls


# ---- the decode at 2,097,152 bits a row, against the JAX package -------------

def test_recover_multikey_at_two_million_bits_matches_jax():
    """A 2048x2048 image at l = 8 carries 2,097,152 bits, past the vote
    kernel's 1,835,008 in shared memory: two rows embedded under their own
    keys (the port, on the CPU), then decoded by the JAX package's
    ``recover_message_bits_multikey`` and by the port's plain path (the
    vote's plain version), equal bit for bit and equal to the messages;
    one latent against both keys too (attribution's shape)."""
    jcfg, cfg = _cfgs(8, size=2048, bits=256)
    assert cfg.capacity_bits == 2_097_152 > chacha.VOTE_MAX_BLOCKS * chacha.BLOCK_BITS
    keys, nonces, msgs = _material(2, seed=99)
    lat, msg = multikey.embed_latents_multikey(cfg, keys, nonces, msgs, device="cpu",
                                               generator=torch.Generator().manual_seed(4))
    got = multikey.recover_message_bits_multikey(lat, cfg, keys, nonces)
    want = np.asarray(jmk.recover_message_bits_multikey(jnp.asarray(lat.numpy()), jcfg,
                                                        keys, nonces))
    np.testing.assert_array_equal(got.numpy(), want)
    bits = np.unpackbits(np.frombuffer(b"".join(msg), np.uint8)).reshape(2, -1)[:, :256]
    np.testing.assert_array_equal(got.numpy(), bits)
    one = multikey.recover_message_bits_multikey(lat[0], cfg, keys, nonces)
    want_one = np.asarray(jmk.recover_message_bits_multikey(jnp.asarray(lat[0].numpy()),
                                                            jcfg, keys, nonces))
    np.testing.assert_array_equal(one.numpy(), want_one)
    np.testing.assert_array_equal(one[0].numpy(), bits[0])
