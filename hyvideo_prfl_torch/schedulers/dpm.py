"""Flow-matching DPM-Solver++ (multistep, order 2), table-driven
(hyvideo_prfl_tpu/schedulers/dpm.py).

The reference's FlowDPMSolverMultistepScheduler at its defaults: x0
prediction, solver order 2, midpoint, lower-order final steps, final
sigma zero. Every step coefficient depends only on the step index, so the
tables are built once in float64 numpy and rounded to fp32, as the JAX
package builds them (a float32 build drifts in ``c_tab``, where r0 is
small); a step is then three multiply-adds over the latent:

    m_t = x - sigma_i v
    x'  = A x + B m_t + C (m_t - m_prev)

with A = sigma_{i+1} / sigma_i, B = -alpha_{i+1} (e^{-h} - 1),
C = 0.5 B / r0 (order 2; 0 at the warm-up and final steps), r0 = h_prev / h.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DPMSchedule:
    """Sigma/timestep grid and the per-step coefficients, fp32 numpy."""

    sigmas: np.ndarray      # [n + 1], last entry 0
    timesteps: np.ndarray   # [n]
    sigma_tab: np.ndarray   # [n] sigma_i of the x0 conversion
    a_tab: np.ndarray       # [n]
    b_tab: np.ndarray       # [n]
    c_tab: np.ndarray       # [n]
    num_train_timesteps: int = 1000

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]

    def row(self, i: int):
        """Step i's (sigma, a, b, c) as Python floats holding fp32 values."""
        return (float(self.sigma_tab[i]), float(self.a_tab[i]), float(self.b_tab[i]),
                float(self.c_tab[i]))


@dataclasses.dataclass
class DPMState:
    m_prev: torch.Tensor  # the last x0-prediction
    step_index: int = 0


def _lam(s: float) -> float:
    s = max(s, 1e-20)
    return math.log1p(-s) - math.log(s)


def dpm_schedule(num_inference_steps: int, shift: float = 5.0,
                 num_train_timesteps: int = 1000) -> DPMSchedule:
    """sigma_max = (N - 1) / N, linspace to 0 over the steps, shift-warped,
    plus a final 0; the coefficient tables in float64, rounded once."""
    n_train = num_train_timesteps
    sigma_max = (n_train - 1) / n_train
    sig = np.linspace(sigma_max, 0.0, num_inference_steps + 1, dtype=np.float64)[:-1]
    sig = shift * sig / (1.0 + (shift - 1.0) * sig)
    timesteps = sig * n_train
    sig = np.concatenate([sig, [0.0]])

    n = num_inference_steps
    a, b, c = np.zeros(n), np.zeros(n), np.zeros(n)
    for i in range(n):
        order = min(2, n - i, i + 1)
        st, s0 = sig[i + 1], sig[i]
        at = 1.0 - st
        if st <= 0.0:
            a[i], b[i], c[i] = 0.0, at, 0.0
            continue
        h = _lam(st) - _lam(s0)
        a[i] = st / max(s0, 1e-20)
        b[i] = -at * (math.exp(-h) - 1.0)
        if order >= 2:
            r0 = (_lam(s0) - _lam(sig[i - 1])) / h
            c[i] = 0.5 * b[i] / r0
    f32 = np.float32
    return DPMSchedule(sigmas=sig.astype(f32), timesteps=timesteps.astype(f32),
                       sigma_tab=sig[:n].astype(f32), a_tab=a.astype(f32),
                       b_tab=b.astype(f32), c_tab=c.astype(f32), num_train_timesteps=n_train)


def init_state(x: torch.Tensor) -> DPMState:
    return DPMState(m_prev=torch.zeros_like(x, dtype=torch.float32), step_index=0)


def dpm_step(schedule: DPMSchedule, state: DPMState, model_output, sample):
    """One step at ``state.step_index`` -> (x_next fp32, state)."""
    sigma, a, b, c = schedule.row(state.step_index)
    x = sample.float()
    m_t = x - sigma * model_output.float()
    x_next = a * x + b * m_t + c * (m_t - state.m_prev)
    return x_next, DPMState(m_prev=m_t, step_index=state.step_index + 1)


def rollout(schedule: DPMSchedule, velocity_fn, x_init: torch.Tensor,
            num_steps: int | None = None):
    """The chain: velocity_fn(x, t) -> v at each table row. Returns
    (x_final, state_final); with ``num_steps`` it stops after that many
    steps (the JAX rollout's ``stop_index``: later steps are identity)."""
    n = schedule.num_steps if num_steps is None else num_steps
    x = x_init.float()
    state = init_state(x)
    for i in range(n):
        x, state = dpm_step(schedule, state, velocity_fn(x, float(schedule.timesteps[i])), x)
    return x, state
