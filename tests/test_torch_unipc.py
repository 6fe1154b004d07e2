"""The port's UniPC solver (hyvideo_prfl_torch/schedulers/unipc.py) against
the JAX package's: the fp32 coefficient tables must be equal, and a
rollout with the same velocity function must agree."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyvideo_prfl_tpu.schedulers import unipc as junipc
from hyvideo_prfl_torch.schedulers import unipc as tunipc

torch.set_num_threads(2)


@pytest.mark.parametrize("steps,shift", [(1, 5.0), (2, 5.0), (3, 5.0), (4, 5.0),
                                         (10, 3.0), (50, 5.0)])
def test_schedule_tables_equal_jax(steps, shift):
    # exact: the same float64 precompute rounded once to fp32
    t = tunipc.unipc_schedule(steps, shift=shift)
    j = junipc.unipc_schedule(steps, shift=shift)
    np.testing.assert_array_equal(t.sigmas, np.asarray(j.sigmas))
    np.testing.assert_array_equal(t.timesteps, np.asarray(j.timesteps))
    for name in tunipc.COEFF_NAMES:
        np.testing.assert_array_equal(t.coeffs[name], np.asarray(getattr(j.coeffs, name)),
                                      err_msg=name)
    assert t.num_steps == j.num_steps == steps


@pytest.mark.parametrize("steps", [3, 8])
def test_rollout_matches_jax(steps):
    rng = np.random.RandomState(0)
    x0 = rng.randn(2, 12, 4, 16).astype(np.float32)
    a = rng.randn(*x0.shape).astype(np.float32) * 0.1

    # a velocity that depends on both the sample and the timestep
    def jvel(x, t):
        return 0.7 * x + a * (t / 1000.0)

    def tvel(x, t):
        return 0.7 * x + torch.from_numpy(a) * (t / 1000.0)

    want, jstate = junipc.rollout(junipc.unipc_schedule(steps), jvel, jnp.asarray(x0))
    got, tstate = tunipc.rollout(tunipc.unipc_schedule(steps), tvel, torch.from_numpy(x0))
    assert tstate.step_index == int(jstate.step_index) == steps
    # fp32 multiply-adds with the same coefficients; XLA may fuse them into
    # fused multiply-adds that round once where PyTorch rounds twice
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tstate.m0.numpy(), np.asarray(jstate.m0), rtol=1e-5, atol=1e-5)


def test_truncated_rollout_continues_to_the_full_chain():
    sched = tunipc.unipc_schedule(5)
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 6, 4, 16).astype(np.float32))

    def vel(x, t):
        return -0.5 * x + t / 1000.0

    full, _ = tunipc.rollout(sched, vel, x)
    cur, state = tunipc.rollout(sched, vel, x, num_steps=3)
    assert state.step_index == 3
    for i in range(3, sched.num_steps):
        cur, state = tunipc._apply(sched.row(i), state, vel(cur, float(sched.timesteps[i])), cur)
    torch.testing.assert_close(cur, full, rtol=0, atol=0)


def test_rollout_passes_the_jax_timesteps():
    seen = []
    tunipc.rollout(tunipc.unipc_schedule(4), lambda x, t: seen.append(t) or x,
                   torch.zeros(1, 2))
    np.testing.assert_array_equal(np.float32(seen),
                                  np.asarray(junipc.unipc_schedule(4).timesteps))
