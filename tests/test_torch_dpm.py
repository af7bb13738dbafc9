"""The DPM scheduler in the port against the JAX package: the per-step
coefficient table, a multi-step trajectory of the scheduler alone on shared
numpy inputs and noise, and the small CogVideoX VAP pipeline under DPM
against the JAX pipeline (the JAX pipeline's per-step noise fed to both).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_step_cache import SEED, call_args, inject_jax_noise, make_pipelines, run_pair
from vap_tpu.ops.schedulers import CogVideoXDPMScheduler as JaxDPM
from vap_tpu_torch.ops.schedulers import CogVideoXDPMScheduler

# float32 on both sides with the same operations in the same order: the
# trajectory differs only where one framework contracts a multiply-add, an
# ulp at a time; held to 1e-6 of max|ref| after 10 steps
TRAJ_REL_TOL = 1e-6


@pytest.mark.parametrize("steps", [4, 10, 50])
def test_step_coefficients_match_jax(steps):
    got = CogVideoXDPMScheduler().step_coefficients(steps)
    want = JaxDPM().step_coefficients(steps)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(CogVideoXDPMScheduler().timesteps(steps), JaxDPM().timesteps(steps))
    # the first and the last step are first order, every other one second
    assert got[6].tolist() == [0.0] + [1.0] * (steps - 2) + [0.0]
    assert np.isfinite(np.stack(got[1:])).all()


def test_multi_step_trajectory_matches_jax():
    """Ten DPM steps with old_x0 carried, on numpy model outputs and noise."""
    steps = 10
    rng = np.random.default_rng(0)
    shape = (1, 3, 4, 8, 8)
    sample0 = rng.standard_normal(shape).astype(np.float32)
    outputs = rng.standard_normal((steps,) + shape).astype(np.float32)
    noises = rng.standard_normal((steps,) + shape).astype(np.float32)
    port, ref = CogVideoXDPMScheduler(), JaxDPM()
    pc = [torch.from_numpy(c) for c in port.step_coefficients(steps)]
    jc = [jnp.asarray(c) for c in ref.step_coefficients(steps)]
    x, old = torch.from_numpy(sample0), torch.zeros(shape)
    jx, jold = jnp.asarray(sample0), jnp.zeros(shape, jnp.float32)
    for i in range(steps):
        x, old = port.step(torch.from_numpy(outputs[i]), x, old, tuple(c[i] for c in pc),
                           torch.from_numpy(noises[i]))
        jx, jold = ref.step(jnp.asarray(outputs[i]), jx, jold, tuple(c[i] for c in jc),
                            jnp.asarray(noises[i]))
        want = np.asarray(jx)
        np.testing.assert_allclose(x.numpy(), want, rtol=0,
                                   atol=TRAJ_REL_TOL * np.abs(want).max())
        np.testing.assert_allclose(old.numpy(), np.asarray(jold), rtol=0,
                                   atol=TRAJ_REL_TOL * np.abs(np.asarray(jold)).max())


def test_first_step_ignores_old_x0():
    """Step 0 is first order: old_x0 (zeros in the pipeline) does not enter."""
    sched = CogVideoXDPMScheduler()
    coeffs = tuple(torch.from_numpy(c)[0] for c in sched.step_coefficients(4))
    rng = np.random.default_rng(1)
    out, x, noise = (torch.from_numpy(rng.standard_normal((2, 3)).astype(np.float32))
                     for _ in range(3))
    a, _ = sched.step(out, x, torch.zeros_like(x), coeffs, noise)
    b, _ = sched.step(out, x, torch.full_like(x, 7.0), coeffs, noise)
    assert torch.equal(a, b)


@pytest.fixture(scope="module")
def dpm_pipelines():
    return make_pipelines()["dpm"]


def test_pipeline_under_dpm_matches_jax(dpm_pipelines):
    """Three DPM steps, no cache: the port draws its per-step noise through
    ``step_noise``, here the JAX pipeline's own noise; float32 end to end as
    the DDIM pipeline test holds it."""
    port, ref = dpm_pipelines
    noise = inject_jax_noise(port, 3)
    got, want = run_pair(port, ref, 3)
    assert not noise  # one draw per step
    assert port.stage_seconds["computed_steps"] == [0, 1, 2]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_pipeline_dpm_noise_comes_from_the_seed(dpm_pipelines):
    """Without injected noise the port draws DPM's per-step noise from a
    generator seeded by ``seed``: with the initial latents given, the same
    seed gives the same latents, another seed other ones."""
    port, _ = dpm_pipelines
    port.__dict__.pop("step_noise", None)
    args, latents = call_args(2)

    def run(seed):
        return port(**{**args, "seed": seed}, latents=torch.from_numpy(latents))

    a, b, c = run(SEED), run(SEED), run(SEED + 1)
    assert torch.equal(a, b) and not torch.equal(a, c)
