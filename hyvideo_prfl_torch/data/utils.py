"""Small data helpers (hyvideo_prfl_tpu/data/utils.py): the align helpers,
a spatio-temporal latent crop and a length-grouped index order, after the
reference's data_utils (align helpers, crop_tensor, LengthGroupedSampler).
The trainers do not call them; they are here for data pipelines built on
the port.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence

import numpy as np


def align_floor_to(value: int, alignment: int) -> int:
    return value // alignment * alignment


def align_ceil_to(value: int, alignment: int) -> int:
    return (value + alignment - 1) // alignment * alignment


def crop_tensor(latents: np.ndarray, crop_ratio: Sequence[float],
                crop_type: str = "random",
                rng: Optional[random.Random] = None) -> np.ndarray:
    """Spatio(-temporal) latent crop (data_utils.py:41-76). latents are
    channel-last [T, H, W, C]; crop_ratio = (t, h, w) fractions kept."""
    rng = rng or random
    t, h, w, _ = latents.shape
    ct = max(1, int(round(t * crop_ratio[0])))
    ch = max(1, int(round(h * crop_ratio[1])))
    cw = max(1, int(round(w * crop_ratio[2])))
    if crop_type == "center":
        t0, h0, w0 = (t - ct) // 2, (h - ch) // 2, (w - cw) // 2
    else:
        t0 = rng.randint(0, t - ct) if t > ct else 0
        h0 = rng.randint(0, h - ch) if h > ch else 0
        w0 = rng.randint(0, w - cw) if w > cw else 0
    return latents[t0:t0 + ct, h0:h0 + ch, w0:w0 + cw]


def group_indices_by_length(lengths: Sequence[int], batch_size: int,
                            world_size: int = 1, seed: int = 0,
                            generator: Optional[np.random.RandomState] = None
                            ) -> List[int]:
    """Frame-length-grouped megabatch ordering (LengthGroupedSampler,
    data_utils.py:116-281): shuffle, slice into megabatches of
    world*batch*8, sort each megabatch by length so co-batched samples
    share shapes."""
    g = generator or np.random.RandomState(seed)
    idx = g.permutation(len(lengths)).tolist()
    mega = world_size * batch_size * 8
    out: List[int] = []
    for i in range(0, len(idx), mega):
        chunk = idx[i:i + mega]
        chunk.sort(key=lambda j: lengths[j])
        out.extend(chunk)
    return out
