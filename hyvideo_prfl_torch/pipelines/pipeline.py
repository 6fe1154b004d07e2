"""Text-to-video sampling pipeline (hyvideo_prfl_tpu/pipelines/pipeline.py).

Batched classifier-free guidance: the cond/uncond pair runs as one
2B-batch DiT forward per step, then UniPC steps the latent. The solver
state stays in the token-cell layout (models/wan_dit.patchify) for the
whole chain; the latent is patchified once before and unpatchified once
after. Not ported yet: i2v/flf2v, the euler and dpm++ solvers, TeaCache
and VAE decode.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..models import wan_dit
from ..schedulers import unipc


def latent_size_for(max_area: int, aspect: float, vae_stride=(4, 8, 8),
                    patch_size=(1, 2, 2), num_frames: int = 81) -> Tuple[int, int, int]:
    """(F, H, W) latent grid from the pixel budget (one GPU: no widening
    for a sequence-parallel degree yet)."""
    lat_f = (num_frames - 1) // vae_stride[0] + 1
    lat_h = round(math.sqrt(max_area * aspect) / vae_stride[1] / patch_size[1]) * patch_size[1]
    lat_w = round(math.sqrt(max_area / aspect) / vae_stride[2] / patch_size[2]) * patch_size[2]
    return lat_f, lat_h, lat_w


@dataclasses.dataclass
class GenerateConfig:
    sampling_steps: int = 40
    guide_scale: float = 5.0
    shift: float = 5.0
    num_train_timesteps: int = 1000


class WanPipeline:
    """Shared cond/uncond CFG sampling over a Wan DiT."""

    def __init__(self, model: wan_dit.WanModel):
        self.model = model
        self.cfg = model.cfg

    def _velocity_cfg(self, x, t, context, context_null, guide_scale, grid):
        b = x.shape[0]
        x2 = torch.cat([x, x], dim=0)
        ctx2 = torch.cat([context, context_null], dim=0)
        t2 = torch.full((2 * b,), t, dtype=torch.float32, device=x.device)
        out = self.model(x2, t2, ctx2, grid=grid)
        cond, uncond = out[:b], out[b:]
        return uncond + guide_scale * (cond - uncond)

    @torch.inference_mode()
    def sample(self, generator: Optional[torch.Generator], latent_shape, context,
               context_null, gen: GenerateConfig,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full denoising chain -> clean latents [B, F, H, W, C] fp32.

        noise: optional starting latent (e.g. another framework's draw);
        otherwise drawn from ``generator`` on the context's device."""
        device = context.device
        if noise is None:
            noise = torch.randn(latent_shape, generator=generator,
                                dtype=torch.float32, device=device)
        noise_t, grid = wan_dit.patchify(noise.to(device, torch.float32),
                                         self.cfg.patch_size)
        sched = unipc.unipc_schedule(gen.sampling_steps, shift=gen.shift,
                                     num_train_timesteps=gen.num_train_timesteps)

        def vel(x, t):
            return self._velocity_cfg(x, t, context, context_null,
                                      gen.guide_scale, grid)

        x, _ = unipc.rollout(sched, vel, noise_t)
        return wan_dit.unpatchify(x, grid, self.cfg.patch_size)


class WanT2V(WanPipeline):
    """Text-to-video."""

    def generate(self, generator, context, context_null, lat_f, lat_h, lat_w,
                 gen: Optional[GenerateConfig] = None,
                 noise: Optional[torch.Tensor] = None):
        gen = gen or GenerateConfig(shift=5.0, sampling_steps=50)
        shape = (context.shape[0], lat_f, lat_h, lat_w, self.cfg.out_dim)
        return self.sample(generator, shape, context, context_null, gen, noise=noise)
