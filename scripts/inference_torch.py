"""Video generation CLI for the PyTorch port (counterpart of scripts/inference.py):
t2v, i2v and flf2v.

Builds the DiT pipeline once and answers each request from it: batched-CFG
UniPC sampling on one GPU, latents written as .npy (the JAX CLI does the
same when it has no VAE weights). Without --ckpt_dir the DiT gets random
weights from the JAX package's initialisers; without --prompt_embeds /
--uncond_embeds the text context is zeros, as in the JAX CLI.

    python3 scripts/inference_torch.py --task t2v-1.3B --size 832*480 \\
        --frame_num 21 --sample_steps 4 [--quant int8] [--quant_attn int8]
    python3 scripts/inference_torch.py --task i2v-14B --size 832*480 \\
        --clip_embeds clip.npy --cond_latent cond.npy

i2v and flf2v take cached inputs, as the JAX CLI does without its
encoders: ``--clip_embeds`` (.npy CLIP features [257, 1280] or
[n, 257, 1280]) and ``--cond_latent`` (.npy VAE latent of the conditioning
frames, [F, H, W, 16]). Each is zeros when not given: [1, 257, 1280] CLIP
features for i2v, [2, 257, 1280] for flf2v (the shape its pipeline takes;
the JAX CLI's [1, 257, 1280] default cannot run flf2v). Sampling defaults
follow the JAX CLI: 40 steps when the task names i2v, else 50; shift 3.0
for i2v at a 480 size, else 5.0.

``--quant int8`` serves the block matmuls as W8A8 int8 GEMMs, the
weights quantized once after they load; ``--quant_attn int8`` runs the
self-attention's q k^T on the int8 path (kernel K10) wherever its keys
stream in several blocks. Either flag works alone. Not ported yet: T5
(--prompt), the CLIP tower and the VAE (--image), TeaCache, LoRA and
multi-GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import random
import sys
from typing import Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hyvideo_prfl_torch.configs import (  # noqa: E402
    MAX_AREA_CONFIGS, SIZE_CONFIGS, dit_config_for_task,
)
from hyvideo_prfl_torch.models import wan_dit  # noqa: E402
from hyvideo_prfl_torch.pipelines.pipeline import (  # noqa: E402
    GenerateConfig, WanFLF2V, WanI2V, WanT2V, latent_size_for,
)
from hyvideo_prfl_torch.utils import checkpoint as ck  # noqa: E402


def args_init(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--task", default="t2v-1.3B")
    p.add_argument("--size", default="480*832")
    p.add_argument("--frame_num", type=int, default=81)
    p.add_argument("--ckpt_dir", default=None,
                   help="reference Wan checkpoint dir (*.safetensors)")
    p.add_argument("--prompt_embeds", default=None,
                   help=".npy [1, L, 4096] cached T5 embedding")
    p.add_argument("--uncond_embeds", default=None)
    p.add_argument("--clip_embeds", default=None,
                   help="i2v/flf2v: .npy CLIP image features [n, 257, 1280]")
    p.add_argument("--cond_latent", default=None,
                   help="i2v/flf2v: .npy conditioning latent [F, H, W, 16]")
    p.add_argument("--sample_steps", type=int, default=None)
    p.add_argument("--sample_shift", type=float, default=None)
    p.add_argument("--sample_guide_scale", type=float, default=5.0)
    p.add_argument("--base_seed", type=int, default=42)
    p.add_argument("--quant", choices=("none", "int8"), default="none",
                   help="serve the DiT block matmuls as W8A8 int8 GEMMs")
    p.add_argument("--quant_attn", choices=("none", "int8"), default="none",
                   help="run the self-attention q k^T on the int8 path (K10)")
    p.add_argument("--save_file", default="out.mp4")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if not any(kind in args.task for kind in ("t2v", "i2v", "flf2v")):
        p.error(f"task {args.task}: only t2v, i2v and flf2v are ported")
    if args.sample_steps is None:
        args.sample_steps = 40 if "i2v" in args.task else 50
    if args.sample_shift is None:
        args.sample_shift = 3.0 if ("i2v" in args.task and "480" in args.size) else 5.0
    if args.base_seed < 0:
        args.base_seed = random.randint(0, 2**31 - 1)
    return args


@dataclasses.dataclass
class Request:
    """One generation: its seed, text contexts, sampling settings and, for
    i2v/flf2v, its image conditioning."""

    seed: int
    context: torch.Tensor       # [1, text_len, text_dim]
    context_null: torch.Tensor  # [1, text_len, text_dim]
    frame_num: int
    sample_steps: int
    sample_shift: float = 5.0
    guide_scale: float = 5.0
    clip_fea: Optional[torch.Tensor] = None     # [1 or 2, 257, 1280]
    cond_latent: Optional[torch.Tensor] = None  # [1, F, H, W, 16]


def pipeline_class(task: str):
    if "flf2v" in task:
        return WanFLF2V
    return WanI2V if "i2v" in task else WanT2V


def build_pipeline(args) -> WanT2V:
    """The DiT on args.device, from --ckpt_dir or random weights, quantized
    after the weights load under --quant int8."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    cfg = dit_config_for_task(args.task, quant_attn=None if args.quant_attn == "none"
                              else args.quant_attn)
    model = wan_dit.WanModel(cfg, device=device)
    if args.ckpt_dir and os.path.isdir(args.ckpt_dir):
        model.load_state_dict(ck.load_reference_dir(args.ckpt_dir, cfg))
    else:
        logging.warning("no --ckpt_dir; random weights")
        wan_dit.init_params(model, torch.Generator(device=device).manual_seed(0))
    if args.quant == "int8":
        model = ck.quantize_model(model)
        logging.info("quantized the block matmuls to int8 (W8A8)")
    return pipeline_class(args.task)(model.eval())


def load_or_zeros(path, shape, device) -> torch.Tensor:
    if path and os.path.exists(path):
        a = np.load(path)
        return torch.from_numpy(a if a.ndim == 3 else a[None]).float().to(device)
    return torch.zeros(shape, dtype=torch.float32, device=device)


def latent_grid(size: str, frame_num: int):
    w, h = SIZE_CONFIGS[size]
    return latent_size_for(MAX_AREA_CONFIGS.get(size, w * h), h / w,
                           num_frames=frame_num)


def clip_shape(task: str):
    """The zero CLIP features' shape when --clip_embeds is not given."""
    return (2 if "flf2v" in task else 1, 257, 1280)


def run_request(pipe: WanT2V, req: Request, size: str) -> torch.Tensor:
    """Latents [1, F, H, W, 16] fp32 for one request."""
    lat_f, lat_h, lat_w = latent_grid(size, req.frame_num)
    gen = GenerateConfig(sampling_steps=req.sample_steps, shift=req.sample_shift,
                         guide_scale=req.guide_scale)
    g = torch.Generator(device=req.context.device).manual_seed(req.seed)
    if isinstance(pipe, WanI2V):
        want = (1, lat_f, lat_h, lat_w, 16)
        if tuple(req.cond_latent.shape) != want:
            raise ValueError(f"cond_latent {tuple(req.cond_latent.shape)}, expected {want}")
        return pipe.generate(g, req.context, req.context_null, req.clip_fea,
                             req.cond_latent, gen)
    return pipe.generate(g, req.context, req.context_null, lat_f, lat_h, lat_w, gen)


def main(argv=None):
    args = args_init(argv)
    logging.basicConfig(level=logging.INFO)
    pipe = build_pipeline(args)
    cfg = pipe.cfg
    device = torch.device(args.device)
    shape = (1, cfg.text_len, cfg.text_dim)
    image = {}
    if isinstance(pipe, WanI2V):
        image = dict(
            clip_fea=load_or_zeros(args.clip_embeds, clip_shape(args.task), device),
            cond_latent=load_or_zeros(args.cond_latent,
                                      (1, *latent_grid(args.size, args.frame_num), 16), device))
    req = Request(
        seed=args.base_seed,
        context=load_or_zeros(args.prompt_embeds, shape, device),
        context_null=load_or_zeros(args.uncond_embeds, shape, device),
        frame_num=args.frame_num, sample_steps=args.sample_steps,
        sample_shift=args.sample_shift, guide_scale=args.sample_guide_scale, **image)
    lat = run_request(pipe, req, args.size)
    out = os.path.splitext(args.save_file)[0] + "_latents.npy"
    np.save(out, lat.cpu().numpy())
    logging.info("latents %s -> %s", tuple(lat.shape), out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
