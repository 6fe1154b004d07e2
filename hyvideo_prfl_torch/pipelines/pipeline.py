"""Video sampling pipelines, T2V, I2V and FLF2V
(hyvideo_prfl_tpu/pipelines/pipeline.py).

Batched classifier-free guidance: the cond/uncond pair runs as one
2B-batch DiT forward per step, then the solver steps the latent:
``GenerateConfig.sample_solver`` picks UniPC, DPM-Solver++ ("dpm++" or
"dpm") or Euler over the shifted flow-matching sigmas. The solver state
stays in the token-cell layout (models/wan_dit.patchify) for the whole
chain; the latent is patchified once before and unpatchified once after.
I2V and FLF2V condition every forward on ``y`` = [mask, cond_latent] (20
channels, patchified once with the noise) and on the CLIP features; both
ride along with the CFG pair. ``sample_teacache`` samples with UniPC and
TeaCache's step skipping (ops/teacache.py), whatever the solver says, as
the JAX package does. The pipeline returns latents; the CLIs decode them
with ``models.vae.decode`` after the DiT is freed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..models import wan_dit
from ..ops import teacache as tc
from ..schedulers import dpm
from ..schedulers import flow_match as fm
from ..schedulers import unipc


def latent_size_for(max_area: int, aspect: float, vae_stride=(4, 8, 8),
                    patch_size=(1, 2, 2), num_frames: int = 81) -> Tuple[int, int, int]:
    """(F, H, W) latent grid from the pixel budget (one GPU: no widening
    for a sequence-parallel degree yet)."""
    lat_f = (num_frames - 1) // vae_stride[0] + 1
    lat_h = round(math.sqrt(max_area * aspect) / vae_stride[1] / patch_size[1]) * patch_size[1]
    lat_w = round(math.sqrt(max_area / aspect) / vae_stride[2] / patch_size[2]) * patch_size[2]
    return lat_f, lat_h, lat_w


def i2v_mask(lat_f: int, lat_h: int, lat_w: int, last_frame: bool = False) -> torch.Tensor:
    """4-channel conditioning mask per latent frame [F, H, W, 4] fp32.

    The pixel-time mask is 1 on frame 0 (and on the last frame for
    flf2v), 0 elsewhere; the first frame is repeated 4x so the (4n+1)-frame
    video maps onto latent frames in groups of 4. On the last latent frame
    only channel 3 is set (training/common.i2v_condition sets all four)."""
    t_pix = (lat_f - 1) * 4 + 1
    msk = np.zeros((t_pix,), np.float32)
    msk[0] = 1.0
    if last_frame:
        msk[-1] = 1.0
    msk = np.concatenate([np.repeat(msk[:1], 4), msk[1:]]).reshape(lat_f, 4)
    return torch.from_numpy(msk)[:, None, None, :].expand(lat_f, lat_h, lat_w, 4)


@dataclasses.dataclass
class GenerateConfig:
    sampling_steps: int = 40
    guide_scale: float = 5.0
    shift: float = 5.0
    sample_solver: str = "unipc"  # unipc | dpm++ (dpm) | euler
    num_train_timesteps: int = 1000


class WanPipeline:
    """Shared cond/uncond CFG sampling over a Wan DiT."""

    def __init__(self, model: wan_dit.WanModel):
        self.model = model
        self.cfg = model.cfg

    def _velocity_cfg(self, x, t, context, context_null, guide_scale, grid,
                      y=None, clip_fea=None):
        b = x.shape[0]
        x2 = torch.cat([x, x], dim=0)
        ctx2 = torch.cat([context, context_null], dim=0)
        t2 = torch.full((2 * b,), t, dtype=torch.float32, device=x.device)
        # the cond and the uncond half see the same image conditioning; the
        # flf2v features [2B, 257, d] repeat as a whole, so each sample's
        # first and last frame stay neighbours for MLPProj's reshape
        y2 = torch.cat([y, y], dim=0) if y is not None else None
        clip2 = torch.cat([clip_fea, clip_fea], dim=0) if clip_fea is not None else None
        out = self.model(x2, t2, ctx2, y=y2, clip_fea=clip2, grid=grid)
        cond, uncond = out[:b], out[b:]
        return uncond + guide_scale * (cond - uncond)

    def _prepare(self, generator, latent_shape, context, noise, y, clip_fea):
        """Noise (drawn unless given), y and clip_fea on the context's
        device, the first two patchified once -> (noise_t, grid, y_t, clip_fea)."""
        device = context.device
        if noise is None:
            noise = torch.randn(latent_shape, generator=generator,
                                dtype=torch.float32, device=device)
        noise_t, grid = wan_dit.patchify(noise.to(device, torch.float32),
                                         self.cfg.patch_size)
        y_t = (wan_dit.patchify(y.to(device, torch.float32), self.cfg.patch_size)[0]
               if y is not None else None)
        clip_fea = clip_fea.to(device) if clip_fea is not None else None
        return noise_t, grid, y_t, clip_fea

    @torch.inference_mode()
    def sample(self, generator: Optional[torch.Generator], latent_shape, context,
               context_null, gen: GenerateConfig,
               noise: Optional[torch.Tensor] = None, y=None, clip_fea=None) -> torch.Tensor:
        """Full denoising chain -> clean latents [B, F, H, W, C] fp32.

        noise: optional starting latent (e.g. another framework's draw);
        otherwise drawn from ``generator`` on the context's device.
        y: optional conditioning video [B, F, H, W, C_y], patchified once;
        clip_fea: optional CLIP features for the image branch."""
        noise_t, grid, y_t, clip_fea = self._prepare(generator, latent_shape, context, noise,
                                                     y, clip_fea)
        n, shift, n_train = gen.sampling_steps, gen.shift, gen.num_train_timesteps

        def vel(x, t):
            return self._velocity_cfg(x, t, context, context_null,
                                      gen.guide_scale, grid, y=y_t, clip_fea=clip_fea)

        if gen.sample_solver == "unipc":
            x, _ = unipc.rollout(unipc.unipc_schedule(n, shift=shift, num_train_timesteps=n_train),
                                 vel, noise_t)
        elif gen.sample_solver in ("dpm++", "dpm"):
            x, _ = dpm.rollout(dpm.dpm_schedule(n, shift=shift, num_train_timesteps=n_train),
                               vel, noise_t)
        elif gen.sample_solver == "euler":
            sched = fm.inference_schedule(n, shift=shift, num_train_timesteps=n_train)
            x = noise_t
            for i in range(sched.num_steps):
                x = fm.euler_step(sched, vel(x, float(sched.timesteps[i])), x, i)
        else:
            raise ValueError(f"unknown solver {gen.sample_solver}")
        return wan_dit.unpatchify(x, grid, self.cfg.patch_size)

    @torch.inference_mode()
    def sample_teacache(self, generator: Optional[torch.Generator], latent_shape, context,
                        context_null, gen: GenerateConfig, thresh: float = 0.2,
                        coeffs_key: str = "t2v-14b", noise: Optional[torch.Tensor] = None,
                        y=None, clip_fea=None) -> torch.Tensor:
        """The UniPC chain with TeaCache's step skipping -> clean latents.

        Each step computes the time embedding of the cond batch alone, asks
        the gate, then runs one 2B-batch CFG forward, either through the
        block stack or adding the cached residual, which stays in that
        batch's order (cond rows, then uncond rows) from step to step, fp32.
        The skipped steps are left in ``self.teacache_skips`` (one bool a
        step)."""
        noise_t, grid, y_t, clip_fea = self._prepare(generator, latent_shape, context, noise,
                                                     y, clip_fea)
        b = noise_t.shape[0]
        n = gen.sampling_steps
        coeffs = tc.COEFFICIENTS[coeffs_key]
        sched = unipc.unipc_schedule(n, shift=gen.shift,
                                     num_train_timesteps=gen.num_train_timesteps)
        ctx2 = torch.cat([context, context_null], dim=0)
        image2 = dict(
            y=torch.cat([y_t, y_t], dim=0) if y_t is not None else None,
            clip_fea=torch.cat([clip_fea, clip_fea], dim=0) if clip_fea is not None else None)
        skips = []

        def vel(x, t, i, extra):
            gate, res2 = extra
            e = wan_dit.time_embed_only(self.model, torch.full((b,), t, device=x.device))
            skip, gate = tc.should_skip(gate, e, i, n, thresh, coeffs)
            skips.append(skip)
            t2 = torch.full((2 * b,), t, dtype=torch.float32, device=x.device)
            out, _, res2 = self.model(torch.cat([x, x], dim=0), t2, ctx2, grid=grid,
                                      skip_blocks=skip, residual_in=res2,
                                      output_residual=True, **image2)
            cond, uncond = out[:b], out[b:]
            return uncond + gen.guide_scale * (cond - uncond), (gate, res2)

        res0 = noise_t.new_zeros((2 * b, noise_t.shape[1], self.cfg.dim))
        x, _, _ = unipc.rollout(sched, vel, noise_t,
                                extra_init=(tc.init_state(noise_t.device), res0))
        self.teacache_skips = skips
        return wan_dit.unpatchify(x, grid, self.cfg.patch_size)


class WanT2V(WanPipeline):
    """Text-to-video."""

    def generate(self, generator, context, context_null, lat_f, lat_h, lat_w,
                 gen: Optional[GenerateConfig] = None,
                 noise: Optional[torch.Tensor] = None):
        gen = gen or GenerateConfig(shift=5.0, sampling_steps=50)
        shape = (context.shape[0], lat_f, lat_h, lat_w, self.cfg.out_dim)
        return self.sample(generator, shape, context, context_null, gen, noise=noise)


class WanI2V(WanPipeline):
    """Image-to-video. ``cond_latent`` is the VAE encoding of [first frame,
    zeros...] ([B, F, H, W, 16]); ``clip_fea`` the first frame's CLIP
    features [B, 257, 1280]."""

    last_frame = False

    def generate(self, generator, context, context_null, clip_fea, cond_latent,
                 gen: Optional[GenerateConfig] = None,
                 noise: Optional[torch.Tensor] = None):
        gen = gen or GenerateConfig(shift=5.0, sampling_steps=40)
        b, lat_f, lat_h, lat_w, _ = cond_latent.shape
        msk = i2v_mask(lat_f, lat_h, lat_w, last_frame=self.last_frame).to(cond_latent.device)
        y = torch.cat([msk[None].expand(b, -1, -1, -1, -1), cond_latent.float()], dim=-1)
        shape = (b, lat_f, lat_h, lat_w, self.cfg.out_dim)
        return self.sample(generator, shape, context, context_null, gen, noise=noise,
                           y=y, clip_fea=clip_fea)


class WanFLF2V(WanI2V):
    """First-and-last-frame-to-video: the mask marks the first and the last
    frame, and ``clip_fea`` holds both frames' features, [2B, 257, 1280]
    (514 image tokens per sample)."""

    last_frame = True
