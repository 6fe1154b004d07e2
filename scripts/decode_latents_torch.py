"""Decode cached latents to video with the port's VAE (counterpart of
scripts/decode_latents.py).

    python3 scripts/decode_latents_torch.py --latents out_latents.npy \\
        --vae_path Wan2.1_VAE.pth [--save_file out.mp4] [--decode_chunk 1] \\
        [--dtype auto|float32|bfloat16] [--fps 15] [--device cuda]

``--latents``: .npy [B, F, H, W, z] (the port's and the JAX package's
layout) or the reference's [B, z, F, H, W], or one clip without B.
``--vae_path``: a reference VAE .pth; the config comes from its shapes.
The decode streams ``--decode_chunk`` latent frames a step (0: the whole
clip) and moves each chunk's frames to the host as it completes;
``--dtype auto`` streams in bf16 above 64e6 pixel-frames (720*1280 at 81
frames), as the JAX script does. The first clip goes to ``--save_file``
as mp4 where imageio or OpenCV can write one, else as uint8
``<stem>_frames.npy`` [T, H, W, 3].
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hyvideo_prfl_torch.models import vae as vae_mod  # noqa: E402
from hyvideo_prfl_torch.utils import encoders, video_io  # noqa: E402


def stream_dtype(cfg: vae_mod.VAEConfig, lat_shape, choice: str) -> torch.dtype:
    """bf16 above 64e6 pixel-frames under ``auto`` (the JAX script's rule)."""
    if choice != "auto":
        return getattr(torch, choice)
    t, s, _ = cfg.stride
    pixels = (1 + (lat_shape[1] - 1) * t) * lat_shape[2] * lat_shape[3] * s * s
    return torch.bfloat16 if pixels > 64e6 else torch.float32


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--latents", required=True,
                   help=".npy [B, F, H, W, z] (or the reference's [B, z, F, H, W])")
    p.add_argument("--vae_path", required=True, help="reference VAE .pth (Wan2.1_VAE.pth)")
    p.add_argument("--save_file", default="out.mp4")
    p.add_argument("--decode_chunk", type=int, default=1,
                   help="latent frames per streaming chunk; 0 = whole-clip")
    p.add_argument("--dtype", default="auto", choices=("auto", "float32", "bfloat16"))
    p.add_argument("--fps", type=int, default=15)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    torch.backends.cudnn.allow_tf32 = False  # fp32 convolutions, not TF32
    vae = encoders.load_reference_vae(args.vae_path, device)
    z_dim = vae.cfg.z_dim
    lat = np.load(args.latents)
    if lat.ndim == 4:
        lat = lat[None]
    if lat.shape[1] == z_dim and lat.shape[-1] != z_dim:  # the reference's layout
        lat = np.transpose(lat, (0, 2, 3, 4, 1))
    dtype = stream_dtype(vae.cfg, lat.shape, args.dtype)
    logging.info("decode dtype: %s", dtype)
    video = vae_mod.decode(vae, torch.from_numpy(np.ascontiguousarray(lat)).to(device),
                           args.decode_chunk, dtype=dtype)
    written = video_io.cache_video(video[0], args.save_file, fps=args.fps)
    logging.info("wrote %s", written)
    return 0


if __name__ == "__main__":
    sys.exit(main())
