"""Flow-matching UniPC multistep solver (hyvideo_prfl_tpu/schedulers/unipc.py).

The configuration the reference uses everywhere: solver_order=2,
predict_x0, flow_prediction, bh2, lower_order_final, final_sigmas zero,
corrector on. Every step coefficient depends only on the step index, so
they are precomputed once in float64 numpy and rounded to fp32, giving the
same table as the JAX package; a step is then a few multiply-adds over
the latent with scalar coefficients, and the rollout is a Python loop over
the table.

Step math, with m the x0-prediction:

    m_t       = x - sigma_i * v
    corrected = A_c x_last + B_c m0 + C_c (m1 - m0) + D_c (m_t - m0)   [i > 0]
    x_next    = A_p x + B_p m_t + C_p (m0 - m_t)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from ..utils import tracing

COEFF_NAMES = ("sigma", "gate_c", "a_c", "b_c", "c_c", "d_c", "a_p", "b_p", "c_p")


@dataclasses.dataclass(frozen=True)
class UniPCSchedule:
    """Sigma/timestep grid plus the per-step coefficient table (fp32 numpy,
    one [num_steps] array per name in COEFF_NAMES)."""

    sigmas: np.ndarray      # [num_steps + 1] fp32, last entry 0
    timesteps: np.ndarray   # [num_steps] fp32
    coeffs: Dict[str, np.ndarray]
    num_train_timesteps: int = 1000

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]

    def row(self, i: int) -> Dict[str, float]:
        """Step i's coefficients as Python floats holding fp32 values."""
        return {k: float(v[i]) for k, v in self.coeffs.items()}


@dataclasses.dataclass
class UniPCState:
    m0: torch.Tensor           # last x0-prediction
    m1: torch.Tensor           # before-last x0-prediction
    last_sample: torch.Tensor  # sample before the last predictor
    step_index: int = 0


def _lam(s: float) -> float:
    s = max(s, 1e-20)
    return math.log1p(-s) - math.log(s)


def _phi_b(h: float) -> Tuple[float, float, float]:
    """(phi1, b1, b2) for bh2 at hh = -h; B_h = phi1."""
    hh = -h
    phi1 = math.expm1(hh)
    b_h = phi1
    k1 = phi1 / hh - 1.0
    b1 = k1 / b_h
    k2 = k1 / hh - 0.5
    b2 = k2 * 2.0 / b_h
    return phi1, b1, b2


def _build_coeffs(sigmas: np.ndarray) -> Dict[str, np.ndarray]:
    """float64 precompute of all per-step coefficients, rounded to fp32."""
    n = len(sigmas) - 1
    sig = sigmas.astype(np.float64)
    out = {k: np.zeros(n) for k in COEFF_NAMES}
    out["sigma"] = sig[:n].copy()
    for i in range(n):
        # predictor order min(2, n - i, i + 1); the corrector at step i uses
        # the order predictor i - 1 chose
        op = min(2, n - i, i + 1)
        oc = min(2, n - (i - 1), i) if i > 0 else 0

        if i > 0:
            st, s0 = sig[i], sig[i - 1]
            at = 1.0 - st
            h = _lam(st) - _lam(s0)
            phi1, b1, b2 = _phi_b(h)
            b_h = phi1
            out["gate_c"][i] = 1.0
            out["a_c"][i] = st / max(s0, 1e-20)
            out["b_c"][i] = -at * phi1
            if oc >= 2:
                s1 = sig[i - 2]
                r = (_lam(s1) - _lam(s0)) / h
                c0 = (b1 - b2) / (1.0 - r)
                c1 = b1 - c0
                out["c_c"][i] = -at * b_h * c0 / r
                out["d_c"][i] = -at * b_h * c1
            else:
                out["c_c"][i] = 0.0
                out["d_c"][i] = -at * b_h * 0.5

        # predictor i -> i+1; at the last step sigma_{i+1} = 0 analytically
        # gives a_p = 0, b_p = alpha_t = 1, c_p = 0
        st, s0 = sig[i + 1], sig[i]
        at = 1.0 - st
        if st <= 0.0:
            out["a_p"][i] = 0.0
            out["b_p"][i] = at
            out["c_p"][i] = 0.0
        else:
            h = _lam(st) - _lam(s0)
            phi1, _, _ = _phi_b(h)
            b_h = phi1
            out["a_p"][i] = st / max(s0, 1e-20)
            out["b_p"][i] = -at * phi1
            if op >= 2:
                s1 = sig[i - 1]
                r = (_lam(s1) - _lam(s0)) / h
                out["c_p"][i] = -at * b_h * 0.5 / r
            else:
                out["c_p"][i] = 0.0
    return {k: v.astype(np.float32) for k, v in out.items()}


def unipc_schedule(num_inference_steps: int, shift: float = 5.0,
                   num_train_timesteps: int = 1000) -> UniPCSchedule:
    """Sigma grid linspace(sigma_max, 0, n+1)[:-1], shift-warped, plus 0."""
    n_train = num_train_timesteps
    sigma_max = (n_train - 1) / n_train
    sig = np.linspace(sigma_max, 0.0, num_inference_steps + 1, dtype=np.float64)[:-1]
    sig = shift * sig / (1.0 + (shift - 1.0) * sig)
    timesteps = sig * n_train
    sig = np.concatenate([sig, [0.0]])
    return UniPCSchedule(
        sigmas=sig.astype(np.float32),
        timesteps=timesteps.astype(np.float32),
        coeffs=_build_coeffs(sig),
        num_train_timesteps=n_train,
    )


def init_state(x: torch.Tensor) -> UniPCState:
    z = torch.zeros_like(x, dtype=torch.float32)
    return UniPCState(m0=z, m1=z, last_sample=z, step_index=0)


def _apply(c: Dict[str, float], state: UniPCState, model_output, sample):
    """One predictor(-corrector) step given a row of the table."""
    sample = sample.float()
    m_t = sample - c["sigma"] * model_output.float()
    if c["gate_c"] > 0:
        sample = (c["a_c"] * state.last_sample + c["b_c"] * state.m0
                  + c["c_c"] * (state.m1 - state.m0)
                  + c["d_c"] * (m_t - state.m0))
    prev_sample = c["a_p"] * sample + c["b_p"] * m_t + c["c_p"] * (state.m0 - m_t)
    return prev_sample, UniPCState(m0=m_t, m1=state.m0, last_sample=sample,
                                   step_index=state.step_index + 1)


def unipc_step(schedule: UniPCSchedule, state: UniPCState, model_output, sample):
    """One predictor(-corrector) step at ``state.step_index``: continues the
    chain from the state a truncated ``rollout`` returns. Differentiable in
    ``model_output`` (PRFL's gradient-carrying step)."""
    return _apply(schedule.row(state.step_index), state, model_output, sample)


def rollout(schedule: UniPCSchedule, velocity_fn, x_init: torch.Tensor,
            num_steps: int | None = None, extra_init=None):
    """The denoising chain: velocity_fn(x, t) -> v at each table row.
    Returns (x_final, state_final); with ``num_steps`` the chain stops
    after that many steps, with ``state.step_index == num_steps``.

    extra_init: a caller's carry threaded through the chain (TeaCache's
    gate and residual caches). With it, velocity_fn(x, t, i, extra) ->
    (v, extra), and rollout returns (x_final, state_final, extra_final).

    Each step is a ``solver.step`` span around a ``solver.model`` span (the
    velocity call; utils/tracing.py)."""
    n = schedule.num_steps if num_steps is None else num_steps
    x = x_init.float()
    state = init_state(x)
    extra = extra_init
    for i in range(n):
        with tracing.span("solver.step"):
            t = float(schedule.timesteps[i])
            with tracing.span("solver.model"):
                if extra_init is None:
                    v = velocity_fn(x, t)
                else:
                    v, extra = velocity_fn(x, t, i, extra)
            x, state = _apply(schedule.row(i), state, v, x)
    if extra_init is None:
        return x, state
    return x, state, extra
