"""The UniPC scheduler in the port against the JAX package: the sigma,
timestep and coefficient tables, and a multi-step trajectory of the
scheduler alone on shared numpy model outputs, its carry included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vap_tpu.ops.schedulers import UniPCScheduler as JaxUniPC
from vap_tpu_torch.ops.schedulers import UniPCScheduler

# float32 on both sides with the same operations in the same order: the
# trajectory may differ only where one framework contracts a multiply-add,
# an ulp at a time; held to 1e-6 of max|ref| at every step
TRAJ_REL_TOL = 1e-6


@pytest.mark.parametrize("steps", [1, 2, 4, 10, 50])
@pytest.mark.parametrize("shift", [1.0, 3.0, 5.0])
def test_tables_match_jax(steps, shift):
    port, ref = UniPCScheduler(shift=shift), JaxUniPC(shift=shift)
    for name in ("sigmas", "timesteps"):
        got, want = getattr(port, name)(steps), getattr(ref, name)(steps)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    got, want = port.step_coefficients(steps), ref.step_coefficients(steps)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype == np.float32 and got[key].shape == (steps,)
        np.testing.assert_array_equal(got[key], want[key])
        assert np.isfinite(got[key]).all(), key
    # orders: the corrector is off at step 0, first order at 1, then second;
    # the predictor is first order at the first and the last step
    assert got["c_order"].tolist() == ([0.0, 1.0] + [2.0] * (steps - 2))[:steps]
    assert got["p_order"].tolist() == ([1.0] if steps == 1 else
                                       [1.0] + [2.0] * (steps - 2) + [1.0])


def test_lam_at_sigma_zero_is_forty():
    """The terminal sigma 0 maps to lambda = 40 (expm1(-40) == -1 in f32),
    not inf: the last predictor coefficient stays finite."""
    from vap_tpu_torch.ops.schedulers.unipc import _lam

    sched = UniPCScheduler()
    lam_last = _lam(float(np.float64(sched.sigmas(4)[-2])))
    assert _lam(0.0) == 40.0
    assert sched.step_coefficients(4)["p_hphi1"][-1] == np.float32(np.expm1(lam_last - 40.0))


@pytest.mark.parametrize("steps", [4, 10])
def test_trajectory_matches_jax(steps):
    """``steps`` UniPC steps on numpy model outputs, the carry (the last two
    x0 predictions and the last sample) carried on both sides."""
    rng = np.random.default_rng(steps)
    shape = (2, 3, 4, 4, 16)
    sample0 = rng.standard_normal(shape).astype(np.float32)
    outputs = rng.standard_normal((steps,) + shape).astype(np.float32)
    port, ref = UniPCScheduler(), JaxUniPC()
    coeffs = ref.step_coefficients(steps)
    x = torch.from_numpy(sample0)
    carry = port.init_carry(x)
    jx, jcarry = jnp.asarray(sample0), ref.init_carry(shape)
    for i in range(steps):
        c = {k: v[i] for k, v in coeffs.items()}
        x, carry = port.step(torch.from_numpy(outputs[i]), x, carry, c)
        jx, jcarry = ref.step(jnp.asarray(outputs[i]), jx, jcarry,
                              {k: jnp.asarray(v) for k, v in c.items()})
        for got, want in zip((x,) + carry, (jx,) + tuple(jcarry)):
            want = np.asarray(want)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=TRAJ_REL_TOL * max(np.abs(want).max(), 1e-30))


def test_step_keeps_the_sample_dtype():
    port = UniPCScheduler()
    c = {k: v[1] for k, v in port.step_coefficients(4).items()}
    x = torch.randn(1, 2, 2, 2, 4, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    out, carry = port.step(torch.ones_like(x), x, port.init_carry(x), c)
    assert out.dtype == torch.bfloat16 and all(t.dtype == torch.float32 for t in carry)
