"""PyTorch port vs the JAX package: the VAE fit (``gswm_torch.utils.fitting``,
``gswm_torch.tools.fit_vae``) on the tiny preset's VAE.

Both packages start from the same parameters (the JAX package's, carried
across by ``models.bridge``) and take the same draws (the JAX package's
``(z, scale)`` sequence, passed in as ``draws=``).  Tolerances, float32 on
both sides:
  * the spectrum and the loss within a relative 1e-4 (the two frameworks
    sum convolutions, FFTs and means in different orders);
  * after three Adam steps, parameters within 1e-5 on >= 99.9% of
    elements.  Adam's first step is a sign step wherever |g| >> eps, so an
    element whose gradient rounds to the other sign moves 2 lr the other
    way; the test prints how many do.
"""

import importlib.util
import os
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gswm.config import GSConfig as JGSConfig
from gswm.core.embed import embed_latents as j_embed
from gswm.models.configs import TINY as J_TINY
from gswm.models.vae import AutoencoderKL as JAutoencoderKL
from gswm.pipelines import InversablePipeline as JPipeline
from gswm.utils import fitting as jfit
from gswm_torch import native
from gswm_torch.config import GSConfig
from gswm_torch.core import bits as bitops
from gswm_torch.core.decode import recover_message_bits
from gswm_torch.distortions.device import brightness
from gswm_torch.models import layers
from gswm_torch.models.bridge import load_pipeline_params_, load_tree_
from gswm_torch.models.configs import TINY
from gswm_torch.models.layers import VAEAttention, init_random_
from gswm_torch.models.vae import AutoencoderKL
from gswm_torch.pipelines import InversablePipeline
from gswm_torch.tools import fit_vae
from gswm_torch.utils import fitting

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
REL = 1e-4


@pytest.fixture(scope="module")
def jvae():
    """The JAX package's tiny VAE (float32) and its random parameters."""
    vae = JAutoencoderKL(J_TINY.vae, dtype=jnp.float32)
    params = vae.init(jax.random.key(0), jnp.zeros((1, 3, 32, 32)))
    return vae, params


def port_vae(params) -> AutoencoderKL:
    with torch.device("meta"):
        vae = AutoencoderKL(TINY.vae)
    vae.to_empty(device="cpu")
    return load_tree_(vae, params).eval().requires_grad_(False)


def j_loss(vae, params, z, scale):
    """The reference fit's ``loss_fn`` (gswm/utils/fitting.py:97-103), which
    is a closure there."""
    img = jnp.clip(vae.apply(params, z, method=JAutoencoderKL.decode), -1.0, 1.0)
    z_back = vae.apply(params, img, method=JAutoencoderKL.encode)
    return jnp.mean(((z_back - z) / scale) ** 2)


def j_draws(steps, batch, latent_hw, seed=42, scale_range=(8.0, 18.0)):
    """The reference fit's draws (gswm/utils/fitting.py:128-134) as numpy."""
    rng = jax.random.key(seed)
    c = J_TINY.vae.latent_channels
    out = []
    for _ in range(steps):
        rng, kz, ks = jax.random.split(rng, 3)
        scale = jax.random.uniform(ks, (batch, 1, 1, 1), minval=scale_range[0],
                                   maxval=scale_range[1])
        z = scale * jax.random.normal(kz, (batch, c) + tuple(latent_hw))
        out.append((np.array(z), np.array(scale)))  # writable, for torch
    return out


def set_switches(monkeypatch, on: bool):
    for name, value in fitting.FIT_SWITCHES.items():
        if on:
            monkeypatch.setenv(name, value)
        else:
            monkeypatch.delenv(name, raising=False)


def test_radial_logpsd_and_spectral_loss_match_jax():
    img = np.random.default_rng(0).uniform(-1, 1, (2, 3, 16, 24)).astype(np.float32)
    want = np.asarray(jfit.radial_logpsd(jnp.asarray(img)))
    got = fitting.radial_logpsd(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, rtol=REL, atol=REL * np.abs(want).max())
    for alpha in (1.0, 2.0):
        want = float(jfit.spectral_loss(jnp.asarray(img), alpha=alpha))
        got = float(fitting.spectral_loss(torch.from_numpy(img), alpha=alpha))
        assert got == pytest.approx(want, rel=REL)


@pytest.mark.parametrize("switches", ["off", "on"])
def test_roundtrip_loss_matches_jax_loss_fn(jvae, monkeypatch, switches):
    """At 40x40 latents the mid attentions hold 1600 tokens, above the
    chunked mode's 1024: with the switches on both packages take their
    chunked attention and checkpoint every block."""
    vae, params = jvae
    set_switches(monkeypatch, switches == "on")
    (z, scale), = j_draws(1, 2, (40, 40), seed=3)
    want = float(j_loss(vae, params, jnp.asarray(z), jnp.asarray(scale)))
    tvae = port_vae(params).requires_grad_(True)
    loss = fitting.roundtrip_loss(tvae, torch.from_numpy(z), torch.from_numpy(scale))
    loss.backward()  # under the switches the checkpointed blocks run again
    assert loss.item() == pytest.approx(want, rel=REL)
    spec = fitting.roundtrip_loss(tvae, torch.from_numpy(z), torch.from_numpy(scale),
                                  spectral=0.5)
    img = jnp.clip(vae.apply(params, jnp.asarray(z), method=JAutoencoderKL.decode), -1, 1)
    assert spec.item() == pytest.approx(
        want + 0.5 * float(jfit.spectral_loss(img)), rel=REL)


def test_three_adam_steps_match_optax(jvae):
    """fit_vae_roundtrip of both packages for 1, 2 and 3 steps on the JAX
    package's draws: the loss of each step (the reference's loss_fn at the
    parameters before it) and the parameters after the third."""
    vae, params = jvae
    steps, batch, hw, lr = 3, 4, (8, 8), 1e-3
    draws = j_draws(steps, batch, hw)
    j_params = [params]
    for k in range(1, steps + 1):
        ns = types.SimpleNamespace(vae=vae, vae_params=params, preset=J_TINY)
        j_params.append(jfit.fit_vae_roundtrip(ns, steps=k, batch=batch, lr=lr,
                                               latent_hw=hw).vae_params)
    want_losses = [float(j_loss(vae, j_params[i], jnp.asarray(z), jnp.asarray(s)))
                   for i, (z, s) in enumerate(draws)]

    states = [port_vae(params).state_dict()]
    for k in range(1, steps + 1):
        tvae = port_vae(params)
        states.append(fitting.fit_vae_roundtrip(tvae, lr=lr, draws=draws[:k]))
        assert not any(p.requires_grad for p in tvae.parameters())
    losses = []
    for state, (z, s) in zip(states, draws):
        tvae = port_vae(params)
        tvae.load_state_dict(state)
        with torch.no_grad():
            losses.append(fitting.roundtrip_loss(tvae, torch.from_numpy(z),
                                                 torch.from_numpy(s)).item())
    np.testing.assert_allclose(losses, want_losses, rtol=REL)
    state = states[-1]

    want = port_vae(j_params[-1]).state_dict()
    total = off = flipped = 0
    for name, t in state.items():
        diff = (t - want[name]).abs()
        total += diff.numel()
        off += int((diff > 1e-5).sum())
        flipped += int((diff > 1.5 * lr).sum())
    print(f"{off} of {total} parameters beyond 1e-5 of optax's, {flipped} of them "
          f"moved the other way (a gradient of the other sign)")
    assert off <= 1e-3 * total


def test_chunked_attention_equals_plain_in_output_and_gradient(monkeypatch):
    """2048 tokens (32 x 64), four chunks of 512 queries: output and the
    gradients of the input and of every parameter within 1e-5 of the
    largest entry, or of 1 where that is smaller (float32; a chunk's matmul
    sums as the whole one does).  The key bias's gradient is zero
    analytically (softmax is shift-invariant), and both sides give it
    rounding noise below 1e-5."""
    attn = VAEAttention(32, norm_groups=8)
    init_random_(attn, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in attn.parameters():  # nonzero biases and norm scales too
            if p.dim() == 1:
                p.normal_(0.0, 0.5, generator=torch.Generator().manual_seed(p.numel()))
    x0 = torch.randn((2, 32, 32, 64), generator=torch.Generator().manual_seed(1))

    def run(chunked):
        if chunked:
            monkeypatch.setenv("GSWM_VAE_ATTN", "chunked")
        else:
            monkeypatch.delenv("GSWM_VAE_ATTN", raising=False)
        attn.zero_grad()
        x = x0.clone().requires_grad_(True)
        out = attn(x)
        (out * torch.linspace(-1, 1, out.numel()).view(out.shape)).sum().backward()
        return [out.detach(), x.grad] + [p.grad.clone() for p in attn.parameters()]

    calls, chunked_attention = [], layers.chunked_attention
    monkeypatch.setattr(layers, "chunked_attention",
                        lambda *a: calls.append(1) or chunked_attention(*a))
    plain = run(False)
    assert not calls
    chunked = run(True)
    assert calls
    for got, want in zip(chunked, plain):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * max(want.abs().max().item(), 1.0))



def test_block_checkpointing_gives_the_same_gradients(jvae, monkeypatch):
    vae, params = jvae
    (z, scale), = j_draws(1, 2, (12, 12), seed=5)
    grads = {}
    for remat in ("", "block"):
        monkeypatch.setenv("GSWM_VAE_REMAT", remat)
        tvae = port_vae(params).requires_grad_(True)
        fitting.roundtrip_loss(tvae, torch.from_numpy(z), torch.from_numpy(scale)).backward()
        grads[remat] = {n: p.grad for n, p in tvae.named_parameters()}
    for name, g in grads[""].items():
        torch.testing.assert_close(grads["block"][name], g, rtol=0, atol=1e-6)


def test_fit_takes_no_kernel_wrapper_even_above_the_flash_threshold(jvae, monkeypatch):
    """At 72x72 latents the mid attentions hold 5184 tokens, above
    VAE_FLASH_MIN_TOKENS: under the fit's switches the chunked attention
    takes precedence, and the split wrapper is never called."""
    vae, params = jvae

    def refuse(*a, **k):
        raise AssertionError("the fit called the split flash wrapper")

    monkeypatch.setattr(layers, "flash_attention_split", refuse)
    (z, scale), = j_draws(1, 1, (72, 72), seed=6)
    state = fitting.fit_vae_roundtrip(port_vae(params), draws=[(z, scale)])
    assert all(torch.isfinite(t).all() for t in state.values())
    assert "GSWM_VAE_ATTN" not in os.environ and "GSWM_VAE_REMAT" not in os.environ
    with pytest.raises(AssertionError):  # outside the fit the threshold holds
        with torch.no_grad():
            port_vae(params).decode(torch.from_numpy(z))


def test_fit_restores_switches_and_grad_flags(jvae, monkeypatch):
    vae, params = jvae
    monkeypatch.setenv("GSWM_VAE_ATTN", "plain")
    monkeypatch.delenv("GSWM_VAE_REMAT", raising=False)
    tvae = port_vae(params)
    with pytest.raises(RuntimeError):  # a draw of 5 channels fails inside the fit
        fitting.fit_vae_roundtrip(tvae, draws=[(np.zeros((1, 5, 8, 8)), np.ones(1))])
    assert os.environ["GSWM_VAE_ATTN"] == "plain" and "GSWM_VAE_REMAT" not in os.environ
    assert not any(p.requires_grad for p in tvae.parameters())


def test_fit_of_a_low_precision_vae_keeps_fp32_masters(jvae):
    """A bf16 VAE (the pipeline's compute copy on the card) is fitted through
    a float32 copy: the state returned is float32, the module keeps its
    dtypes (norms float32) and holds that state rounded."""
    vae, params = jvae
    tvae = layers.to_compute_dtype_(port_vae(params), "cpu", torch.bfloat16)
    draws = j_draws(2, 2, (8, 8))
    state = fitting.fit_vae_roundtrip(tvae, draws=draws)
    assert all(t.dtype == torch.float32 for t in state.values())
    for name, p in tvae.named_parameters():
        want = torch.float32 if "norm" in name else torch.bfloat16
        assert p.dtype == want, name
        assert torch.equal(p, state[name].to(p.dtype))
    start = port_vae(params).state_dict()
    assert any(not torch.equal(state[n], start[n]) for n in state)


def _reference_tool():
    spec = importlib.util.spec_from_file_location(
        "fit_sd21_vae", ROOT / "tools" / "fit_sd21_vae.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sign_fidelity_equals_reference(jvae):
    """tools/fit_sd21_vae.py's sign_fidelity and the port's on the same
    latents (the reference's own draw, 14 x N(0, 1) from key 123): equal to
    within one element of the 8 x 4 x 16 x 16."""
    vae, params = jvae
    ns = types.SimpleNamespace(vae=vae, vae_params=params, preset=J_TINY)
    want = _reference_tool().sign_fidelity(ns, (16, 16))
    z = 14.0 * jax.random.normal(jax.random.key(123), (8, 4, 16, 16))
    got = fit_vae.sign_agreement(port_vae(params), torch.from_numpy(np.array(z)))
    assert abs(got - want) <= 1.0 / z.size
    assert fit_vae.fid_batch(64) == 8 and fit_vae.fid_batch(96) == 3
    assert fit_vae.fid_batch(128) == 2 and fit_vae.fid_batch(512) == 1


def test_fit_tool_stages_write_a_loadable_state(tmp_path, capsys):
    out = tmp_path / "fitted.pt"
    results = fit_vae.main(["--preset", "tiny", "--device", "cpu", "--out", str(out),
                            "--stages", "8:6:2:1e-3,12:2:1:1e-4"])
    assert [(r["hw"], r["steps"], r["batch"]) for r in results] == [(8, 6, 2), (12, 2, 1)]
    printed = capsys.readouterr().out
    assert "stage 8x8: 6 steps, batch 2, lr 0.001" in printed and "steps/s" in printed
    state = torch.load(out, weights_only=True)
    vae = fit_vae.build_vae("tiny", "cpu", seed=9)
    vae.load_state_dict(state)
    assert all(torch.equal(v, state[k]) for k, v in vae.state_dict().items())
    fit_vae.main(["--preset", "tiny", "--device", "cpu", "--init", str(out),
                  "--check", "8,16"])
    assert "sign fidelity @16x16" in capsys.readouterr().out
    assert fit_vae.parse_stages(fit_vae.STAGES) == [
        (16, 1500, 32, 1e-3), (32, 500, 16, 3e-4), (64, 250, 8, 1e-4)]


def test_refuse_grad_predicate():
    """The rule every kernel wrapper applies on the CUDA branch before it
    launches: under grad mode an input that requires grad raises, naming the
    wrapper; without either it passes."""
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="flash_attention_split.*GSWM_VAE_ATTN=chunked"):
        native.refuse_grad("flash_attention_split", torch.zeros(2), x)
    with torch.no_grad():
        native.refuse_grad("flash_attention_split", x)
    with torch.inference_mode():
        native.refuse_grad("fused_group_norm", torch.zeros(2))
    native.refuse_grad("fused_group_norm", torch.zeros(2))


@pytest.fixture(scope="module")
def fitted_pipe():
    """The reference test's tiny pipeline (tests/test_pipeline.py:48-59, its
    weights carried across by the bridge), its VAE fitted by the port with
    the defaults (600 steps, batch 16, 8x8 latents) on the JAX fit's draws;
    ~45 s of fit on two CPU threads."""
    jpipe = JPipeline("tiny", rng=jax.random.key(0))
    pipe = InversablePipeline("tiny", device="cpu", dtype=torch.float32)
    load_pipeline_params_(pipe, jpipe.unet_params, jpipe.vae_params, jpipe.text_params)
    fitting.fit_vae_roundtrip(pipe, draws=j_draws(600, 16, (8, 8)))
    return pipe


def test_full_image_roundtrip_on_the_fitted_vae(fitted_pipe):
    """tests/test_pipeline.py:61-79 on the port, on the reference test's
    Z_T: 20-step generate -> VAE decode -> VAE encode -> 20-step inversion
    -> vote.  The tiny VAE has 2 levels, so 8x8 latents are 16x16 images."""
    kw = dict(key_hex="22" * 32, nonce_hex="33" * 16, message="lthero",
              width=16, height=16, vae_scale=2, message_bits=32)
    jzt, msg = j_embed(JGSConfig(**kw), rng=jax.random.key(6))
    cfg = GSConfig(**kw)
    img = fitted_pipe.generate(torch.from_numpy(np.array(jzt)), guidance_scale=1.0,
                               num_steps=20)
    assert img.shape == (1, 3, 16, 16)
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0
    accs = []
    for x in (img, brightness(img, 2.5)):  # the second for the record only
        z_back = fitted_pipe.invert(images=x, num_steps=20)
        voted = recover_message_bits(z_back, cfg).numpy()[0]
        accs.append(float(np.mean(voted == bitops.bytes_to_bits(msg))))
    acc = accs[0]
    fid = fit_vae.sign_fidelity(fitted_pipe.vae, (8, 8))
    print(f"fitted tiny VAE: closed-loop bit accuracy {acc}, sign fidelity {fid}, "
          f"mean pixel {float(img.mean())}, after brightness x 2.5 {accs[1]}")
    assert acc > 0.9, acc
    assert fid > 0.8, fid
