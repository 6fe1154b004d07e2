"""Seeded latent caches in the reference's on-disk layout (the program's
data/dataset.py reads them): a meta list of JSON files, each naming the
clip's VAE latents [1, 16, F, H, W] and its short and long caption
embeddings [1, n, 4096] as .npy files, with a quality label for the reward
model; and the null and uncond text embeddings under ``null/wanx/``.

Every array is drawn from the run's seed, so the benchmark knows what the
program's loader must hand it. The caption lengths are the traffic file's
fixed list, shuffled by the seed, so every seed has the same set of sizes.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List

import numpy as np


@dataclasses.dataclass
class Clip:
    latents: np.ndarray  # [F, H, W, 16], as the loader returns it
    short: np.ndarray    # [n, 4096]
    long: np.ndarray
    label: float


@dataclasses.dataclass
class Cache:
    meta_list: str
    null_dir: str
    clips: List[Clip]
    null: np.ndarray     # [n, 4096]: the dropped caption's embedding
    uncond: np.ndarray


def write(root: str, seed: int, traffic: dict, text_dim: int = 4096) -> Cache:
    """The traffic's ``clips`` clips at its latent grid under ``root``."""
    rng = np.random.default_rng(seed)
    f, h, w = latent_grid(traffic)
    lens = list(traffic["caption_tokens"])
    null_dir = os.path.join(root, "null")
    os.makedirs(os.path.join(null_dir, "wanx"), exist_ok=True)
    os.makedirs(os.path.join(root, "clips"), exist_ok=True)
    nulls = {}
    for name in ("null", "uncond"):
        nulls[name] = rng.standard_normal((1, traffic["null_tokens"], text_dim), np.float32)
        np.save(os.path.join(null_dir, "wanx", f"{name}.npy"), nulls[name])
    first_good = bool(rng.integers(2))
    clips, lines = [], []
    for i in range(traffic["clips"]):
        stem = os.path.join(root, "clips", f"clip{i}")
        lat = rng.standard_normal((1, 16, f, h, w), np.float32)
        n_short, n_long = rng.permutation(lens)[:2]
        short = rng.standard_normal((1, int(n_short), text_dim), np.float32)
        long = rng.standard_normal((1, int(n_long), text_dim), np.float32)
        good = (i % 2 == 0) == first_good
        meta = {"vae_latent_path": stem + ".npy", "textshort_path": stem + "_short.npy",
                "textlong_path": stem + "_long.npy", "short_caption": f"clip {i}",
                "long_caption": f"the longer caption of clip {i}",
                "motion_quality": "good" if good else "poor"}
        np.save(meta["vae_latent_path"], lat)
        np.save(meta["textshort_path"], short)
        np.save(meta["textlong_path"], long)
        with open(stem + "_meta.json", "w") as fh:
            json.dump(meta, fh)
        lines.append(stem + "_meta.json")
        clips.append(Clip(np.ascontiguousarray(np.transpose(lat[0], (1, 2, 3, 0))),
                          short[0], long[0], 1.0 if good else 0.0))
    meta_list = os.path.join(root, "clips.list")
    with open(meta_list, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return Cache(meta_list, null_dir, clips, nulls["null"][0], nulls["uncond"][0])


def latent_grid(traffic: dict):
    """(F, H, W) of the traffic's video: the VAE's 4x time and 8x space strides."""
    v = traffic["video"]
    return (v["frames"] - 1) // 4 + 1, v["height"] // 8, v["width"] // 8


def padded(text: np.ndarray, text_len: int) -> np.ndarray:
    out = np.zeros((text_len, text.shape[1]), np.float32)
    n = min(text_len, text.shape[0])
    out[:n] = text[:n]
    return out


def match(cache: Cache, latents: np.ndarray, text: np.ndarray, text_len: int):
    """The clip whose latents and one of whose captions (or the null
    embedding) the loader handed over, bit for bit -> (clip, text), or
    None where nothing matches."""
    for clip in cache.clips:
        if clip.latents.shape == latents.shape and np.array_equal(clip.latents, latents):
            for cand in (clip.long, clip.short, cache.null):
                ref = padded(cand, text_len)
                if np.array_equal(ref, text):
                    return clip, ref
            return None
    return None
