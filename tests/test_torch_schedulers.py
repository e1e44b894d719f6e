"""PyTorch port vs the JAX package: DPM++ 2M plans and steps, the scheduler
map, and the 768 presets' v-prediction schedule.

Plans are host numpy on both sides (float32 alphas): equal exactly.  Steps
run in float32 on the same inputs: atol 1e-6 plus rtol 4e-6, because the
first inverse step cancels two terms ~15x its result (sigma ratio 15.2
against alpha * expm1(-h) 14.3 from alpha 0.99915), which amplifies one
fp32 rounding of either side to ~12 ulps of the result.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gswm.schedulers import SCHEDULERS as J_SCHEDULERS
from gswm.schedulers import dpm as jdpm
from gswm.schedulers import sd_schedule as j_sd_schedule
from gswm_torch.pipelines import inversable
from gswm_torch.schedulers import SCHEDULERS, dpm, sd_schedule
from gswm_torch.schedulers.ddim import to_eps


@pytest.mark.parametrize("num_steps", [1, 10, 14, 30, 50])
@pytest.mark.parametrize("inverse", [False, True], ids=["plan", "inverse_plan"])
def test_dpm_plans_equal_jax(num_steps, inverse):
    sched = sd_schedule()
    jplan = (jdpm.dpm_inverse_plan if inverse else jdpm.dpm_plan)(
        j_sd_schedule(), num_steps)
    plan = (dpm.dpm_inverse_plan if inverse else dpm.dpm_plan)(sched, num_steps)
    for name in ("t_model", "alpha_eval", "alpha_from", "alpha_to"):
        got, want = getattr(plan, name), np.asarray(getattr(jplan, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(plan.extras["first_order"],
                                  np.asarray(jplan.extras["first_order"]))


@pytest.mark.parametrize("inverse", [False, True], ids=["generate", "invert"])
def test_dpm_steps_match_jax(inverse):
    """Six steps of the plan.  Each step gives both sides the same inputs (x,
    eps and the carry, from the port's previous step), so the bound holds per
    step and does not compound; eps = 0.9 x + 0.3 n_i (denoiser-like: at high
    noise eps follows x, so pred_x0 stays O(1))."""
    n = 6
    plan = (dpm.dpm_inverse_plan if inverse else dpm.dpm_plan)(sd_schedule(), n)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 4, 8, 8)).astype(np.float32))
    noise = rng.standard_normal((n, 2, 4, 8, 8)).astype(np.float32)
    carry = dpm.dpm_init_carry(x.shape)
    for i in range(n):
        a_from, a_to = plan.alpha_from[i], plan.alpha_to[i]
        first = plan.extras["first_order"][i]
        eps = 0.9 * x + 0.3 * torch.from_numpy(noise[i])
        jx, jcarry = jdpm.dpm_step(
            jnp.asarray(x.numpy()), jnp.asarray(eps.numpy()), jnp.float32(a_from),
            jnp.float32(a_to),
            (jnp.asarray(carry[0].numpy()), jnp.float32(carry[1].item()),
             jnp.asarray(carry[2])), jnp.asarray(first))
        x, carry = dpm.dpm_step(x, eps, torch.tensor(a_from), torch.tensor(a_to),
                                carry, bool(first))
        assert x.dtype == torch.float32
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=4e-6,
                                   atol=1e-6, err_msg=f"step {i}")
        np.testing.assert_allclose(carry[0].numpy(), np.asarray(jcarry[0]),
                                   rtol=4e-6, atol=1e-6)
        np.testing.assert_allclose(carry[1].item(), float(jcarry[1]), rtol=0,
                                   atol=1e-6)
        assert carry[2] == bool(jcarry[2])


def test_scheduler_map_matches_jax():
    assert sorted(SCHEDULERS) == sorted(J_SCHEDULERS) == ["DDIM", "DPMs"]
    for name, (plan_fn, inv_fn) in SCHEDULERS.items():
        assert plan_fn.__name__ == J_SCHEDULERS[name][0].__name__
        assert inv_fn.__name__ == J_SCHEDULERS[name][1].__name__


@pytest.mark.parametrize("preset", ["sd-2-1", "sd-2-0"])
def test_768_preset_builds_the_v_prediction_schedule(monkeypatch, preset):
    """``InversablePipeline("sd-2-1")`` runs on the v-prediction schedule of
    the JAX package's preset (weights stubbed: only the schedule is under
    test here; the v-prediction step loop is held against JAX in
    tests/test_torch_pipeline.py)."""
    monkeypatch.setattr(inversable, "_build",
                        lambda cls, cfg, generator: torch.nn.Identity())
    pipe = inversable.InversablePipeline(preset, device="cpu")
    assert pipe.preset.default_resolution == 768
    assert pipe.schedule.prediction_type == "v_prediction"
    want = j_sd_schedule(prediction_type="v_prediction")
    np.testing.assert_array_equal(pipe.schedule.alphas_cumprod, want.alphas_cumprod)
    assert pipe.schedule.final_alpha_cumprod == want.final_alpha_cumprod
    x = torch.ones(())
    a = torch.tensor(0.25)
    # eps = sqrt(a) v + sqrt(1-a) x
    assert to_eps(x, 2 * x, a, pipe.schedule.prediction_type).item() == pytest.approx(
        0.5 * 2 + 0.75**0.5)
