"""TeaCache: time-embedding-gated skipping of the DiT's block stack at
inference (hyvideo_prfl_tpu/ops/teacache.py).

Between denoising steps the relative L1 change of the time embedding e
(the fp32 time MLP's output, ``wan_dit.time_embed_only``) is rescaled by a
fitted polynomial and accumulated; while the sum stays under the
threshold, the step skips the block stack and adds the residual (block
stack out - in) cached at the last computed step. The first and the last
step always compute, and a computed step resets the sum.

The gate is fp32 arithmetic on the device, as the JAX package's, and
returns a Python bool: one host sync per step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# fitted rescale polynomials (highest degree first), the reference's
COEFFICIENTS = {
    "i2v-480p": (-3.02331670e2, 2.23948934e2, -5.25463970e1,
                 5.87348440e0, -2.01973289e-1),
    "i2v-720p": (-114.36346466, 65.26524496, -18.82220707,
                 4.91518089, -0.23412683),
    "t2v-1.3b": (2.39676752e3, -1.31110545e3, 2.01331979e2,
                 -8.29855975e0, 1.37887774e-1),
    "t2v-14b": (-5784.54975374, 5449.50911966, -1811.16591783,
                256.27178429, -13.02252404),
}


@dataclasses.dataclass
class TeaCacheState:
    prev_mod_input: Optional[torch.Tensor]  # [B, dim] fp32 e of the last step
    accum: torch.Tensor                     # fp32 scalar, the rescaled rel-L1 sum


def init_state(device=None) -> TeaCacheState:
    return TeaCacheState(prev_mod_input=None,
                         accum=torch.zeros((), dtype=torch.float32, device=device))


def _poly(coeffs, x: torch.Tensor) -> torch.Tensor:
    y = torch.zeros_like(x)
    for c in coeffs:
        y = y * x + c
    return y


def should_skip(state: TeaCacheState, mod_input: torch.Tensor, step_index: int,
                num_steps: int, thresh: float, coeffs) -> Tuple[bool, TeaCacheState]:
    """(skip this step?, the next state). First and last steps, and the
    first call, compute; otherwise accumulate poly(rel_l1(e, prev_e)) and
    skip while the sum is under ``thresh``."""
    e = mod_input.float()
    forced = step_index in (0, num_steps - 1) or state.prev_mod_input is None
    if state.prev_mod_input is None:
        accum = state.accum
    else:
        prev = state.prev_mod_input
        rel = (e - prev).abs().mean() / prev.abs().mean().clamp_min(1e-8)
        accum = state.accum + _poly(coeffs, rel)
    skip = not forced and bool(accum < thresh)
    return skip, TeaCacheState(prev_mod_input=e,
                               accum=accum if skip else torch.zeros_like(accum))
