"""Flow-matching schedules and the Euler solver
(hyvideo_prfl_tpu/schedulers/flow_match.py).

The schedule is a pair of fp32 tables built the JAX package's way; the
draws take an explicit ``torch.Generator``, or come in from the caller
(tests hand the JAX draws to both packages).

* train sigmas: linspace(sigma_max, 0, N + 1); timesteps = sigmas[:-1] * N
* inference sigmas: the same linspace over the steps, warped by the shift
  s sigma / (1 + (s - 1) sigma); Euler step x += v (sigma_{i+1} - sigma_i)
* add_noise: (1 - sigma) x0 + sigma eps;  target: v = eps - x0
* timestep sampling: logit-normal or uniform u, index floor(u N)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FlowMatchSchedule:
    """sigmas [num_steps + 1] fp32 (ending at 0) and timesteps [num_steps]."""

    sigmas: torch.Tensor
    timesteps: torch.Tensor
    num_train_timesteps: int = 1000

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]


def train_schedule(num_train_timesteps: int = 1000, sigma_max: float = 1.0,
                   reverse: bool = True) -> FlowMatchSchedule:
    """Linear sigmas sigma_max -> 0 (no shift warp), rounded once to fp32
    (within one fp32 ulp of the JAX package's jnp.linspace table)."""
    sigmas = np.linspace(sigma_max, 0.0, num_train_timesteps + 1).astype(np.float32)
    if not reverse:
        sigmas = sigmas[::-1].copy()
    timesteps = (sigmas[:-1] * np.float32(num_train_timesteps)).astype(np.float32)
    return FlowMatchSchedule(sigmas=torch.from_numpy(sigmas),
                             timesteps=torch.from_numpy(timesteps),
                             num_train_timesteps=num_train_timesteps)


def _linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """jnp.linspace(start, stop, num, dtype=float32) as XLA evaluates it on
    the CPU: start (1 - i r) + stop i r in fp32 with r = fp32(1 / div), the
    endpoint appended (equal to it up to 352 points, within an fp32 ulp
    above)."""
    div = num - 1
    step = np.arange(div, dtype=np.float32) * np.float32(1.0 / div)
    out = (np.float32(start) * (np.float32(1) - step) + np.float32(stop) * step)
    return np.concatenate([out, np.float32([stop])]).astype(np.float32)


def inference_schedule(num_inference_steps: int, shift: float = 1.0,
                       num_train_timesteps: int = 1000) -> FlowMatchSchedule:
    """Inference schedule: fp32 linspace 1 -> 0 warped by the shift,
    s sigma / (1 + (s - 1) sigma) (the euler solver's sigmas)."""
    sigmas = _linspace_f32(1.0, 0.0, num_inference_steps + 1)
    shift = np.float32(shift)
    sigmas = (shift * sigmas) / (np.float32(1) + (shift - np.float32(1)) * sigmas)
    timesteps = sigmas[:-1] * np.float32(num_train_timesteps)
    return FlowMatchSchedule(sigmas=torch.from_numpy(sigmas.astype(np.float32)),
                             timesteps=torch.from_numpy(timesteps.astype(np.float32)),
                             num_train_timesteps=num_train_timesteps)


def euler_step(schedule: FlowMatchSchedule, model_output, sample, step_index: int):
    """One Euler step x + v (sigma_{i+1} - sigma_i), fp32."""
    dt = schedule.sigmas[step_index + 1] - schedule.sigmas[step_index]
    return sample.float() + model_output.float() * float(dt)


def add_noise(original_samples, noise, sigma):
    """x_sigma = (1 - sigma) * x0 + sigma * eps."""
    return (1.0 - sigma) * original_samples + sigma * noise


def train_target(original_samples, noise):
    """Flow-matching velocity target v = eps - x0."""
    return noise - original_samples


def loss_weighting(sigma):
    return torch.ones_like(sigma)


def sample_train_timestep(schedule: FlowMatchSchedule, batch_size: int,
                          weighting_scheme: str = "logit_normal",
                          logit_mean: float = 0.0, logit_std: float = 1.0,
                          generator: Optional[torch.Generator] = None,
                          u: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw (timestep [B], sigma [B]) fp32.

    logit_normal: u = sigmoid(N(mean, std)); uniform: u ~ U[0, 1). The
    draw comes from ``generator``, or is ``u`` itself when given (already
    transformed); index = clip(floor(u N), 0, num_steps - 1)."""
    if u is None:
        dev = generator.device if generator is not None else "cpu"
        if weighting_scheme == "logit_normal":
            u = torch.sigmoid(torch.randn(batch_size, generator=generator, device=dev)
                              * logit_std + logit_mean)
        else:
            u = torch.rand(batch_size, generator=generator, device=dev)
    idx = (u.float().cpu() * schedule.num_train_timesteps).to(torch.int64)
    idx = idx.clamp(0, schedule.num_steps - 1)
    return schedule.timesteps[idx], schedule.sigmas[idx]


def sigma_for_timestep(schedule: FlowMatchSchedule, timestep) -> torch.Tensor:
    """sigma of the nearest train timestep (the JAX package's argmin match)."""
    t = torch.atleast_1d(torch.as_tensor(timestep, dtype=torch.float32))
    idx = (schedule.timesteps[None, :] - t[:, None]).abs().argmin(dim=1)
    return schedule.sigmas[idx]
