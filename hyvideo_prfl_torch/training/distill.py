"""Distillation utilities: the Euler sub-solver and the latent GAN
discriminator heads (hyvideo_prfl_tpu/training/distill.py).

``extract_into_tensor`` and ``get_phase_endpoint`` are the multiphase
helpers; ``EulerSolver`` steps over a subsampled sigma grid; the
discriminator heads score DiT feature taps [B, L, C] with two dense
layers, a group norm and a leaky ReLU each, and a scalar output (the JAX
package writes the reference's 1x1 convolutions as dense layers). Plain
PyTorch in fp32, as the JAX package leaves them to XLA; no CLI calls them
(the reference's two main workloads do not), and
``discriminator_from_flax`` carries a flax parameter tree across.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def extract_into_tensor(a, t, x_shape) -> torch.Tensor:
    """a[t] reshaped to [B, 1, 1, ...] of x's rank."""
    a = torch.as_tensor(np.asarray(a)) if not isinstance(a, torch.Tensor) else a
    out = a[torch.as_tensor(t, device=a.device).long()]
    return out.reshape(out.shape[0], *((1,) * (len(x_shape) - 1)))


def get_phase_endpoint(index: int, num_teacher_timesteps: int = 32,
                       multiphase: int = 8) -> int:
    """A teacher step index floored to its phase boundary, capped at the
    last phase's start."""
    interval = num_teacher_timesteps // multiphase
    max_endpoint = num_teacher_timesteps - interval
    if index >= max_endpoint:
        return max_endpoint
    return (index // interval) * interval


@dataclasses.dataclass(frozen=True)
class EulerSolver:
    """Discrete Euler over a subsampled sigma grid: ``sigmas`` [n_full + 1]
    the full training grid (fp32), ``indices`` [n_sub] the subsampled
    positions in it, ascending."""

    sigmas: torch.Tensor
    indices: torch.Tensor

    @classmethod
    def make(cls, sigmas, timesteps: int, euler_timesteps: int):
        step_ratio = timesteps // euler_timesteps
        idx = (np.arange(1, euler_timesteps + 1) * step_ratio).round()[::-1]
        idx = (idx - 1).astype(np.int64)[::-1].copy()
        return cls(sigmas=torch.from_numpy(np.asarray(sigmas, np.float32)),
                   indices=torch.from_numpy(idx))

    def euler_step(self, sample, model_output, index: int) -> torch.Tensor:
        """x - v (sigma_i - sigma_{i+1}) at subsampled step ``index`` (the
        last step goes to the grid's end)."""
        index = int(index)
        i = self.indices[index]
        i_next = (self.indices[index + 1] if index + 1 < self.indices.shape[0]
                  else self.sigmas.shape[0] - 1)
        return sample.float() - model_output.float() * (self.sigmas[i] - self.sigmas[i_next])

    def euler_step_to_target(self, sample, model_output, index: int,
                             target_index: int) -> torch.Tensor:
        """A jump from subsampled step ``index`` to ``target_index``."""
        sigma = self.sigmas[self.indices[int(index)]]
        sigma_t = self.sigmas[self.indices[int(target_index)]]
        return sample.float() - model_output.float() * (sigma - sigma_t)


def _group_norm(x, groups: int = 32, eps: float = 1e-6):
    """Normalise [B, L, C] over each of ``groups`` channel groups (no affine)."""
    b, l, c = x.shape
    g = x.reshape(b, l, groups, c // groups)
    mean = g.mean(dim=-1, keepdim=True)
    var = g.var(dim=-1, keepdim=True, unbiased=False)
    return ((g - mean) * torch.rsqrt(var + eps)).reshape(b, l, c)


class DiscriminatorHead(nn.Module):
    """feat [B, L, C] -> [B, L, 1]: conv1, group norm, leaky ReLU, conv2 with
    a residual, group norm, leaky ReLU, conv_out (dense layers, fp32)."""

    def __init__(self, feature_dim: int, inner_dim: int = 1024, device=None):
        super().__init__()
        self.conv1 = nn.Linear(feature_dim, inner_dim, device=device)
        self.conv2 = nn.Linear(inner_dim, inner_dim, device=device)
        self.conv_out = nn.Linear(inner_dim, 1, device=device)

    def forward(self, feat):
        x = self.conv1(feat.float())
        x = F.leaky_relu(_group_norm(x, 32), 0.2)
        x = self.conv2(x) + x
        x = F.leaky_relu(_group_norm(x, 32), 0.2)
        return self.conv_out(x)


class Discriminator(nn.Module):
    """One DiscriminatorHead per feature tap (``head_<i>``)."""

    def __init__(self, feature_dim: int, num_heads: int = 3, inner_dim: int = 1024,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        for i in range(num_heads):
            self.add_module(f"head_{i}", DiscriminatorHead(feature_dim, inner_dim, device))

    def forward(self, feats: Sequence[torch.Tensor]):
        return [getattr(self, f"head_{i}")(f) for i, f in enumerate(feats)]


def discriminator_from_flax(tree: Dict) -> Dict[str, torch.Tensor]:
    """A flax Discriminator's (or DiscriminatorHead's) parameters -> the
    port's state dict (each Dense kernel [in, out] to a Linear weight
    [out, in])."""
    params = tree.get("params", tree)
    out = {}

    def walk(node, prefix):
        for name, sub in node.items():
            if "kernel" in sub:
                out[f"{prefix}{name}.weight"] = torch.from_numpy(
                    np.array(sub["kernel"], np.float32).T.copy())
                out[f"{prefix}{name}.bias"] = torch.from_numpy(np.array(sub["bias"], np.float32))
            else:
                walk(sub, f"{prefix}{name}.")

    walk(params, "")
    return out
