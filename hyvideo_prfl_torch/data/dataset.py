"""Latent-cache dataset, refl mode (hyvideo_prfl_tpu/data/dataset.py).

The reference's on-disk cache, unchanged:

* a "meta list" text file of JSON paths, one per line;
* each JSON holds npy paths: ``vae_latent_path`` [1, C, T, H, W] fp32,
  ``textshort_path``/``textlong_path`` [1, L, text_dim] (or
  ``text_en_path``) and captions; for i2v also ``f1_black_path`` (or
  ``latents_condition_path``), the first-frame conditioning latent
  [1, 16, T, H, W], and ``imgclip_path``, the CLIP features [1, 257, 1280];
* ``{null_dir}/wanx/{null,uncond,uncond_flf2v}.npy`` null and uncond text
  embeddings (flf2v has its own uncond).

Samples come out channel-last (latents and ``cond`` [T, H, W, C],
``clip_fea`` [n * 257, 1280]) with text padded to a fixed ``text_len``, as
the JAX package returns them. Only the PRFL ("refl") mode is ported, as
this class; the reward-model modes and the native read-ahead ring are not.
"""

from __future__ import annotations

import functools
import json
import os
import random
from typing import Dict, List, Optional, Sequence

import numpy as np

NULL_DIR = "temp_data/null"
# chance of the long caption where a sample has both (the reference's 0.7)
LONG_CAPTION_PROB = 0.7


@functools.lru_cache(maxsize=8)
def _load_null_npy(path):
    return np.load(path)


def _to_thwc(lat_1cthw: np.ndarray) -> np.ndarray:
    """[1, C, T, H, W] (reference layout) -> [T, H, W, C] fp32."""
    return np.transpose(lat_1cthw[0], (1, 2, 3, 0)).astype(np.float32)


def _pad_text(t: np.ndarray, text_len: int) -> np.ndarray:
    """[L, D] -> [text_len, D], zero-padded or truncated."""
    l, d = t.shape
    if l >= text_len:
        return t[:text_len].astype(np.float32)
    out = np.zeros((text_len, d), np.float32)
    out[:l] = t
    return out


class LatentCacheDataset:
    """Map-style dataset over cached latents, retrying a random other
    sample up to 100 times on a bad one (as the reference does)."""

    def __init__(self, meta_file_list: Sequence[str] = (),
                 uncond_prob: Sequence[float] = (0.0, 0.0), text_len: int = 512,
                 null_dir: Optional[str] = None, is_i2v: bool = True,
                 is_flf2v: bool = False, seed: Optional[int] = None):
        self.uncond_prompt_prob = uncond_prob[0]
        self.text_len = text_len
        self.null_dir = null_dir or NULL_DIR
        self.is_i2v = is_i2v
        self.is_flf2v = is_flf2v
        self.rng = random.Random(seed)
        self.meta_paths: List[str] = []
        for meta_file in meta_file_list:
            with open(meta_file) as f:
                self.meta_paths.extend(ln.strip() for ln in f if ln.strip())

    def __len__(self):
        return len(self.meta_paths)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        for _ in range(100):
            try:
                return self.get_refl(idx)
            except Exception as e:  # noqa: BLE001 -- any bad sample is resampled
                idx = self.rng.randrange(len(self.meta_paths))
                last = e
        raise RuntimeError(f"Too many bad data: {last}")

    def _null_text(self, name: str) -> np.ndarray:
        return _load_null_npy(os.path.join(self.null_dir, f"wanx/{name}.npy"))[0]

    def get_refl(self, idx: int) -> Dict[str, np.ndarray]:
        """PRFL sample: latents, text (dropped to the null embedding with
        probability uncond_prob[0]), uncond_text, prompt; with is_i2v also
        cond and clip_fea, where the meta names them."""
        with open(self.meta_paths[idx]) as f:
            d = json.load(f)
        lat = next((d[k] for k in ("video_vae_latent_path", "vae_latent_path", "latents_path")
                    if k in d), None)
        if lat is None:
            raise FileNotFoundError("no latent path key in meta")
        if "textshort_path" in d and "textlong_path" in d:
            if self.rng.random() <= LONG_CAPTION_PROB:
                text_p, prompt = d["textlong_path"], d.get("long_caption", "")
            else:
                text_p, prompt = d["textshort_path"], d.get("short_caption", "")
        else:
            text_p, prompt = d["text_en_path"], d.get("prompt", "")
        if self.rng.random() < self.uncond_prompt_prob:
            text = self._null_text("null")
        else:
            text = np.load(text_p)[0]
        out = {
            "latents": _to_thwc(np.load(lat)),
            "text": _pad_text(text, self.text_len),
            "uncond_text": _pad_text(
                self._null_text("uncond_flf2v" if self.is_flf2v else "uncond"), self.text_len),
            "prompt": prompt,
        }
        if not self.is_i2v:
            return out
        cond = next((d[k] for k in ("f1_black_path", "latents_condition_path") if k in d), None)
        if cond is not None:
            out["cond"] = _to_thwc(np.load(cond))
        if "imgclip_path" in d:
            clip = np.load(d["imgclip_path"])  # [1, 257, 1280] or [b, s, d]
            out["clip_fea"] = clip.reshape(-1, clip.shape[-1]).astype(np.float32)
        return out
