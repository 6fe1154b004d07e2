"""Latent-cache dataset (hyvideo_prfl_tpu/data/dataset.py).

The reference's on-disk cache, unchanged:

* a "meta list" text file of JSON paths, one per line;
* each JSON holds npy paths: ``vae_latent_path`` [1, C, T, H, W] fp32,
  ``textshort_path``/``textlong_path`` [1, L, text_dim] (or
  ``text_en_path``) and captions; for i2v also ``f1_black_path`` (or
  ``latents_condition_path``), the first-frame conditioning latent
  [1, 16, T, H, W], and ``imgclip_path``, the CLIP features [1, 257, 1280];
  for the reward model a quality label ("good"/"poor" or 0/1);
* ``{null_dir}/wanx/{null,uncond,uncond_flf2v}.npy`` null and uncond text
  embeddings (flf2v has its own uncond).

Samples come out channel-last (latents and ``cond`` [T, H, W, C],
``clip_fea`` [n * 257, 1280]) with text padded to a fixed ``text_len``, as
the JAX package returns them. The modes (``dataset_type``) are the JAX
package's: "refl" (PRFL), "lrm_ce" (a sample and its quality label,
``labels``) and "lrm_bt_online" (a sample and a random entry of the lose
list, ``latents_lose`` and, for i2v, ``cond_lose``). Every random choice
draws from the dataset's ``random.Random(seed)`` in the JAX package's
order, so one seed gives the same captions, drops and lose pairs in both
packages. A sample's files (latents, text, condition, CLIP features) are
read in parallel through the read-ahead ring (``data/native_loader.py``),
as the JAX package reads them; replayed samples are memory-mapped instead.

``EvalPromptDataset`` is the serving CLI's ``--prompt_file``: a txt file of
prompts, or a JSON list of records with a prompt and an optional image.
"""

from __future__ import annotations

import functools
import json
import os
import random
from typing import Dict, List, Optional, Sequence

import numpy as np

from .native_loader import NativeStream

NULL_DIR = "temp_data/null"
# chance of the long caption where a sample has both (the reference's 0.7)
LONG_CAPTION_PROB = 0.7
QUALITY_KEYS = ("text_alignment", "blur_quality", "physics_quality", "human_quality",
                "motion_quality")
DATASET_TYPES = ("refl", "lrm_ce", "lrm_bt_online")


@functools.lru_cache(maxsize=8)
def _load_null_npy(path):
    return np.load(path)


def _to_thwc(lat_1cthw: np.ndarray) -> np.ndarray:
    """[1, C, T, H, W] (reference layout) -> [T, H, W, C] fp32 (a view of
    fp32 input)."""
    return np.transpose(lat_1cthw[0], (1, 2, 3, 0)).astype(np.float32, copy=False)


def _pad_text(t: np.ndarray, text_len: int) -> np.ndarray:
    """[L, D] -> [text_len, D], zero-padded or truncated."""
    l, d = t.shape
    if l >= text_len:
        return t[:text_len].astype(np.float32)
    out = np.zeros((text_len, d), np.float32)
    out[:l] = t
    return out


def coerce_label(v) -> float:
    """'good'/'poor', or anything truthy -> 1.0/0.0."""
    if isinstance(v, str):
        return 1.0 if v.strip().lower() == "good" else 0.0
    return float(bool(v))


def _read_list(meta_files: Sequence[str]) -> List[str]:
    paths: List[str] = []
    for meta_file in meta_files:
        with open(meta_file) as f:
            paths.extend(ln.strip() for ln in f if ln.strip())
    return paths


def _meta(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _latent_path(d: Dict) -> str:
    lat = next((d[k] for k in ("video_vae_latent_path", "vae_latent_path", "latents_path")
                if k in d), None)
    if lat is None:
        raise FileNotFoundError("no latent path key in meta")
    return lat


def _cond_path(d: Dict) -> Optional[str]:
    return next((d[k] for k in ("f1_black_path", "latents_condition_path") if k in d), None)


class LatentCacheDataset:
    """Map-style dataset over cached latents, retrying a random other
    sample up to 100 times on a bad one (as the reference does)."""

    def __init__(self, meta_file_list: Sequence[str] = (),
                 uncond_prob: Sequence[float] = (0.0, 0.0), text_len: int = 512,
                 null_dir: Optional[str] = None, is_i2v: bool = True,
                 is_flf2v: bool = False, seed: Optional[int] = None,
                 dataset_type: str = "refl", meta_file_lose_list: Sequence[str] = (),
                 label_key: str = "motion_quality"):
        if dataset_type not in DATASET_TYPES:
            raise ValueError(f"unknown dataset_type {dataset_type}")
        self.dataset_type = dataset_type
        self.uncond_prompt_prob = uncond_prob[0]
        self.text_len = text_len
        self.label_key = label_key
        self.null_dir = null_dir or NULL_DIR
        self.is_i2v = is_i2v
        self.is_flf2v = is_flf2v
        self.rng = random.Random(seed)
        self._mmap = None  # "r" while replay() maps the arrays rather than reading them
        self._stream = None  # the read-ahead ring, opened at the first read
        self.meta_paths = _read_list(meta_file_list)
        self.meta_paths_lose = _read_list(meta_file_lose_list)

    def __len__(self):
        return len(self.meta_paths)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        get = {"refl": self.get_refl, "lrm_ce": self.get_lrm_ce,
               "lrm_bt_online": self.get_lrm_bt_online}[self.dataset_type]
        for _ in range(100):
            try:
                return get(idx)
            except Exception as e:  # noqa: BLE001 -- any bad sample is resampled
                idx = self.rng.randrange(len(self.meta_paths))
                last = e
        raise RuntimeError(f"Too many bad data: {last}")

    def replay(self, idx: int) -> Dict[str, np.ndarray]:
        """self[idx] with the latents, conditions and CLIP features memory-
        mapped rather than read: the same draws and shapes, at the cost of
        the meta and the text embedding. The loader replays with it the
        batches a resumed run skips."""
        self._mmap = "r"
        try:
            return self[idx]
        finally:
            self._mmap = None

    def _read_many(self, paths: Sequence[Optional[str]]) -> List[Optional[np.ndarray]]:
        """The arrays of one sample's files (None entries pass through),
        read in parallel through the ring, or memory-mapped in a replay."""
        real = [p for p in paths if p is not None]
        if self._mmap:
            arrays = iter([np.load(p, mmap_mode=self._mmap) for p in real])
        else:
            if self._stream is None:
                self._stream = NativeStream()
            arrays = iter(self._stream.read_many(real))
        return [next(arrays) if p is not None else None for p in paths]

    def _null_text(self, name: str) -> np.ndarray:
        return _load_null_npy(os.path.join(self.null_dir, f"wanx/{name}.npy"))[0]

    def _paths(self, idx: int):
        """(latent path, text path, prompt, cond path, clip path) of a meta;
        the long caption is drawn where the meta has both. The files load
        after every draw of the sample, as in the JAX package, so a bad file
        leaves the stream of draws where the JAX package leaves it."""
        d = _meta(self.meta_paths[idx])
        lat = _latent_path(d)
        if "textshort_path" in d and "textlong_path" in d:
            if self.rng.random() <= LONG_CAPTION_PROB:
                text, prompt = d["textlong_path"], d.get("long_caption", "")
            else:
                text, prompt = d["textshort_path"], d.get("short_caption", "")
        else:
            text, prompt = d["text_en_path"], d.get("prompt", "")
        cond = _cond_path(d) if self.is_i2v else None
        clip = d.get("imgclip_path") if self.is_i2v else None
        return lat, text, prompt, cond, clip

    def _load(self, lat, text, prompt, cond, clip) -> Dict:
        """The sample's arrays; ``text`` None takes the null embedding."""
        lat, text, cond, clip = self._read_many([lat, text, cond, clip])
        text = text[0] if text is not None else self._null_text("null")
        out = {"latents": _to_thwc(lat), "text": _pad_text(text, self.text_len),
               "prompt": prompt}
        if cond is not None:
            out["cond"] = _to_thwc(cond)
        if clip is not None:  # [1, 257, 1280] or [b, s, d]
            out["clip_fea"] = clip.reshape(-1, clip.shape[-1]).astype(np.float32, copy=False)
        return out

    def get_refl(self, idx: int) -> Dict[str, np.ndarray]:
        """PRFL sample: latents, text (dropped to the null embedding with
        probability uncond_prob[0]), uncond_text, prompt; with is_i2v also
        cond and clip_fea, where the meta names them."""
        lat, text_p, prompt, cond, clip = self._paths(idx)
        drop = self.rng.random() < self.uncond_prompt_prob
        out = self._load(lat, None if drop else text_p, prompt, cond, clip)
        out["uncond_text"] = _pad_text(
            self._null_text("uncond_flf2v" if self.is_flf2v else "uncond"), self.text_len)
        return out

    def get_refl_no_drop(self, idx: int) -> Dict[str, np.ndarray]:
        """A sample without the text drop and without uncond_text."""
        lat, text_p, prompt, cond, clip = self._paths(idx)
        return self._load(lat, text_p, prompt, cond, clip)

    def get_lrm_ce(self, idx: int) -> Dict[str, np.ndarray]:
        """A pointwise reward sample: get_refl_no_drop and ``labels``, the
        meta's ``label_key`` (else its first quality key) as 1.0/0.0."""
        d = _meta(self.meta_paths[idx])
        out = self.get_refl_no_drop(idx)
        if self.label_key in d:
            out["labels"] = np.float32(coerce_label(d[self.label_key]))
        else:
            labels = [coerce_label(d[k]) for k in QUALITY_KEYS if k in d]
            if not labels:
                raise FileNotFoundError(f"no quality label in {self.meta_paths[idx]}")
            out["labels"] = np.float32(labels[0])
        return out

    def get_lrm_bt_online(self, idx: int) -> Dict[str, np.ndarray]:
        """A pairwise sample: the win is ``idx``, the lose a random entry of
        the lose list (drawn after the win's caption): its latents and, for
        i2v, its condition latent."""
        win = self.get_refl_no_drop(idx)
        d = _meta(self.meta_paths_lose[self.rng.randrange(len(self.meta_paths_lose))])
        lat, cond = self._read_many([_latent_path(d), _cond_path(d) if self.is_i2v else None])
        win["latents_lose"] = _to_thwc(lat)
        if cond is not None:
            win["cond_lose"] = _to_thwc(cond)
        return win


class EvalPromptDataset:
    """Prompt (and image) records for inference runs: a txt file of
    prompts, one a line, or a JSON list of {prompt | caption |
    short_caption, image_path | img_path, ...} records (the record's other
    keys kept). ``self[idx]`` also loads the image, when it exists, resized
    aspect-preserving to 16-aligned sides covering height x width and
    cropped to them, in [-1, 1] (PIL)."""

    def __init__(self, path: str, height: int = 480, width: int = 832):
        self.items: List[Dict] = []
        self.height = height
        self.width = width
        if path.endswith(".txt"):
            with open(path) as f:
                self.items = [{"prompt": ln.strip()} for ln in f if ln.strip()]
        else:
            with open(path) as f:
                data = json.load(f)
            for d in data:
                self.items.append({
                    "prompt": d.get("prompt") or d.get("caption") or d.get("short_caption", ""),
                    "image_path": d.get("image_path") or d.get("img_path"),
                    **{k: v for k, v in d.items() if k not in ("prompt", "caption")},
                })

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int) -> Dict:
        item = dict(self.items[idx])
        img_path = item.get("image_path")
        if img_path and os.path.exists(img_path):
            from PIL import Image

            img = Image.open(img_path).convert("RGB")
            w0, h0 = img.size
            scale = max(self.height / h0, self.width / w0)
            img = img.resize((int(round(w0 * scale / 16)) * 16,
                              int(round(h0 * scale / 16)) * 16))
            arr = np.asarray(img, np.float32) / 127.5 - 1.0
            item["image"] = arr[:self.height, :self.width]
        return item
