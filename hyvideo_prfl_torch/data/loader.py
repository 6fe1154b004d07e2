"""Sampler, batching and the single-device batch iterator
(hyvideo_prfl_tpu/data/loader.py, the one-replica path).

The JAX package gives each data-parallel replica a contiguous block of
the dataset; one GPU is one replica, whose block is the whole dataset.
Batches are stacked per key (string fields become lists); mixed-shape
caches are bucketed so every batch is shape-uniform. A resumed run does
not start at an offset, as the JAX trainers do: it replays the stream from
the start and drops the batches its steps took (``skip_batches``), so the
dataset's draws (captions, text drops, lose pairs), the shuffle's epochs
and the buckets come out as in an uninterrupted run.
"""

from __future__ import annotations

from typing import Dict, Iterator, Sequence

import numpy as np


class BlockDistributedSampler:
    """The one replica's index block: range(dataset_len), shuffled per
    epoch when asked."""

    def __init__(self, dataset_len: int, shuffle: bool = False, seed: int = 0):
        self.dataset_len = dataset_len
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self):
        return self.dataset_len

    def __iter__(self) -> Iterator[int]:
        idxs = list(range(self.dataset_len))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idxs)
        return iter(idxs)


def stack_batch(samples: Sequence[Dict]) -> Dict[str, np.ndarray]:
    """Stack per-sample dicts; string fields become lists."""
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        out[k] = vals if isinstance(vals[0], str) else np.stack([np.asarray(v) for v in vals])
    return out


def _shape_key(sample: Dict) -> tuple:
    return tuple((k, np.asarray(v).shape) for k, v in sorted(sample.items())
                 if not isinstance(v, str))


class BatchIterator:
    """Infinite, epoch-wrapping iterator of shape-uniform batches, less the
    first ``skip_batches``: those are replayed (``dataset.replay``, which
    maps the arrays rather than reading them) and dropped unstacked."""

    def __init__(self, dataset, sampler: BlockDistributedSampler, batch_size: int = 1,
                 skip_batches: int = 0):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.skip_batches = skip_batches

    def __iter__(self):
        epoch, skip = 0, self.skip_batches
        buckets: Dict[tuple, list] = {}
        while True:
            self.sampler.set_epoch(epoch)
            consumed = False
            for idx in self.sampler:
                sample = self.dataset.replay(idx) if skip else self.dataset[idx]
                consumed = True
                key = _shape_key(sample)
                buckets.setdefault(key, []).append(sample)
                if len(buckets[key]) == self.batch_size:
                    batch = buckets.pop(key)
                    if skip:
                        skip -= 1
                    else:
                        yield stack_batch(batch)
            epoch += 1
            if not consumed:
                raise RuntimeError("the data stream made no progress in a full epoch")
