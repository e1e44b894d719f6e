"""The port's golden NumPy oracle (``gswm_torch.compat``) against the port's
vectorized core, as tests/test_embed_decode.py:61-99 holds the JAX core to
``gswm.compat``; and the oracle equal to the JAX package's copy."""

import numpy as np
import pytest
import torch

from gswm.compat import numpy_reference as jref
from gswm_torch.compat import reference_decode_numpy, reference_embed_numpy
from gswm_torch.config import GSConfig, prepare_message_bytes
from gswm_torch.core import bits as bitops
from gswm_torch.core.decode import decode_latents, recover_message_bits
from gswm_torch.core.embed import embed_latents

KEY_HEX = "5822ff9cce6772f714192f43863f6bad1bf54b78326973897e6b66c3186b77a7"
NONCE_HEX = "05072fd1c2265f6f2e2a4080a2bfbdd8"


def _cfg(**kw):
    base = dict(key_hex=KEY_HEX, nonce_hex=NONCE_HEX, message="lthero")
    base.update(kw)
    return GSConfig(**base)


def test_parity_vs_numpy_reference_embed():
    """Same u, same key material: the latent within the fp32-ndtri-vs-fp64
    ppf gap of the scalar oracle, its signs (the embedded bits) equal, and
    its decode the oracle's decode."""
    cfg = _cfg(message_bits=256)
    key, nonce = cfg.resolve_key_nonce()
    msg = prepare_message_bytes("lthero", 32)
    u = np.random.default_rng(11).uniform(size=(1, 16384)).astype(np.float64)
    golden = reference_embed_numpy(key, nonce, msg, 512, 512, l=1, u=u)
    ours, _ = embed_latents(cfg, message_bytes=msg, u=u, device="cpu")
    np.testing.assert_allclose(ours[0].numpy(), golden, atol=5e-4)
    np.testing.assert_array_equal(ours[0].numpy() > 0, golden > 0)
    got = reference_decode_numpy(ours[0].numpy(), key, nonce, 256)
    assert got == bitops.bits_to_bin_str(recover_message_bits(ours, cfg)[0].numpy())


def test_parity_vs_numpy_reference_decode():
    cfg = _cfg(message_bits=256)
    key, nonce = cfg.resolve_key_nonce()
    lat = np.random.default_rng(5).normal(size=(4, 64, 64)).astype(np.float32)
    assert decode_latents(torch.from_numpy(lat), cfg) == reference_decode_numpy(
        lat, key, nonce, 256)


def test_decode_parity_l2():
    cfg = _cfg(width=256, height=256, message_bits=64, l=2)
    key, nonce = cfg.resolve_key_nonce()
    lat = np.random.default_rng(9).normal(size=(4, 32, 32)).astype(np.float32)
    assert decode_latents(torch.from_numpy(lat), cfg) == reference_decode_numpy(
        lat, key, nonce, 64, l=2)


@pytest.mark.parametrize("l", [1, 2])
def test_oracle_equals_the_jax_packages(l):
    key, nonce = bytes(range(32)), bytes(range(16))
    msg = bytes(range(8))
    u = np.random.default_rng(l).uniform(size=16384 // l)
    ours = reference_embed_numpy(key, nonce, msg, 256, 256, l=l, u=u)
    np.testing.assert_array_equal(ours, jref.reference_embed_numpy(key, nonce, msg, 256,
                                                                   256, l=l, u=u))
    assert reference_decode_numpy(ours, key, nonce, 64, l=l) == \
        jref.reference_decode_numpy(ours, key, nonce, 64, l=l)
