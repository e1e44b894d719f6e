"""The plain reference against the measured port on the CPU, in float32 at
the port's tiny presets: the same weights, the same inputs, the same
answers to float32 rounding. And its watermark against the port's."""

import json

import numpy as np
import pytest
import torch

from h100bench import check, cells, inputs, program
from h100bench.reference import chacha, ddim
from h100bench.reference.pipeline import Reference

DATA = cells.HERE / "tests" / "data"
SEED = 2 ** 33 + 17


def _config(name: str) -> dict:
    config = json.loads((DATA / "configs" / f"{name}.json").read_text())
    config["dtype"] = "float32"
    return config


def _close(a, b, tol=2e-5):
    a, b = a.double(), b.double()
    assert float((a - b).norm() / b.norm()) < tol


@pytest.fixture(scope="module", params=["tiny", "tiny-xl"])
def pair(request):
    torch.manual_seed(0)
    config = _config(request.param)
    states = inputs.make_states(config, SEED, "cpu")
    return config, program.build(config, states, "cpu"), Reference(config, states, "cpu")


def test_unet_vae_and_text(pair):
    config, pipe, ref = pair
    g = torch.Generator().manual_seed(3)
    res = config["default_resolution"]
    f = 2 ** (len(config["vae"]["block_out_channels"]) - 1)
    images = torch.rand((2, 3, res, res), generator=g)
    ids = np.array([[998, 5, 17, 999] + [999] * 73] * 2)
    with torch.inference_mode():
        _close(pipe.image_to_latents(images), ref.modules["vae"].encode(images))
        lat = torch.randn((2, 4, res // f, res // f), generator=g)
        _close(pipe.decode_image(lat), ref.modules["vae"].decode(lat))
        ctx = pipe.encode_prompt_ids(ids)
        _close(ctx, ref.encode_prompt(ids))
        added = pipe.default_added_cond(2, res, res)
        want_added = ref.added_cond(2, res, res)
        if added is not None:
            _close(added["text_embeds"], want_added["text_embeds"])
        t = torch.tensor(501)
        _close(pipe.unet(lat, t, ctx, added), ref.modules["unet"](lat, t, ctx, want_added))


def test_chains(pair):
    config, pipe, ref = pair
    res = config["default_resolution"]
    images = torch.rand((2, 3, res, res), generator=torch.Generator().manual_seed(4))
    _close(pipe.invert(images=images, num_steps=3), ref.extract(images, 3)["z_T"], 1e-4)
    f = 2 ** (len(config["vae"]["block_out_channels"]) - 1)
    z = torch.randn((1, 4, res // f, res // f), generator=torch.Generator().manual_seed(5))
    ids = np.array([[998, 3, 4, 999] + [999] * 73])
    got = pipe.generate(z, prompt_ids=ids, guidance_scale=7.5, num_steps=3, decode=False)
    with torch.inference_mode():
        uncond = ref.encode_prompt(ref.modules["text"].empty_prompt_ids(1))
        want = ddim.run(ref.modules["unet"], z, ref.encode_prompt(ids), config["scheduler"], 3,
                        invert=False, added=ref.added_cond(1, res, res), uncond=uncond,
                        guidance=7.5)
    _close(got, want, 1e-4)


def test_ddim_plans_are_the_ports():
    from gswm_torch.schedulers.ddim import ddim_inverse_plan, ddim_plan
    from gswm_torch.schedulers.schedule import sd_schedule

    sched = _config("tiny")["scheduler"]
    for steps in (3, 30, 50):
        for invert, port in ((False, ddim_plan), (True, ddim_inverse_plan)):
            p = port(sd_schedule(), steps)
            ts, a_eval, a_from, a_to = ddim.plan(sched, steps, invert)
            assert np.array_equal(ts, p.t_model)
            for got, want in ((a_eval, p.alpha_eval), (a_from, p.alpha_from), (a_to, p.alpha_to)):
                assert np.array_equal(got, want)


@pytest.mark.parametrize("nonce_hex", ["33" * 16, "ff" * 7 + "fe" + "01" * 8])
def test_chacha20_is_the_ports_and_the_librarys(nonce_hex):
    """Bit-exact against the port's plain keystream, and against the
    `cryptography` package's ChaCha20, the counter carrying into its high
    word on the second nonce."""
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms

    from gswm_torch.core import chacha as port

    key, nonce = bytes(range(32)), bytes.fromhex(nonce_hex)
    got = chacha.keystream_bits(key, nonce, 4 * 512 + 40)
    assert torch.equal(got, port.keystream_bits(key, nonce, 4 * 512 + 40, "cpu"))
    enc = Cipher(algorithms.ChaCha20(key, nonce), mode=None).encryptor()
    stream = np.frombuffer(enc.update(bytes(4 * 64 + 5)), dtype=np.uint8)
    assert np.array_equal(got.numpy(), np.unpackbits(stream)[: got.numel()])


def test_embed_then_extract_reads_the_message():
    requests = inputs.Requests(_config("tiny"), {"resolution": 64, "batch": 3,
                                                 "message_bits": 32}, SEED, "cpu")
    n = int(np.prod(requests.latent_shape))
    z = chacha.embed(requests.uniforms(0), check.cipher_bits(requests), 1, requests.latent_shape)
    bits = chacha.extract(z.float(), chacha.keystream_bits(requests.key, requests.nonce, n), 1, 32)
    want = np.unpackbits(np.frombuffer(requests.message, dtype=np.uint8))
    assert np.array_equal(bits.numpy(), np.tile(want, (3, 1)))


def test_embed_is_the_ports():
    from gswm_torch.config import GSConfig
    from gswm_torch.core.embed import embed_latents

    requests = inputs.Requests(_config("tiny"), {"resolution": 64, "batch": 2,
                                                 "message_bits": 32}, SEED, "cpu")
    cfg = GSConfig(key_hex=requests.key.hex(), nonce_hex=requests.nonce.hex(),
                   message_bits=32, width=64, height=64, vae_scale=2)
    u = requests.uniforms(1)
    got, _ = embed_latents(cfg, batch=2, u=u, message_bytes=requests.message,
                           replicate=False, device="cpu")
    want = chacha.embed(u, check.cipher_bits(requests), 1, requests.latent_shape)
    assert float((got.double() - want).abs().max()) < 1e-5
