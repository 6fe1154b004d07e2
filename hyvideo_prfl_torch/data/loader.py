"""Sampler, batching, the batch iterator with its read-ahead thread and
the data-parallel zip (hyvideo_prfl_tpu/data/loader.py).

The JAX package gives each data-parallel replica a contiguous block of
the dataset; one replica's block is the whole dataset. With several
replicas (``DataParallelLoader``) every process walks all the replicas'
streams over one dataset in the JAX zip's order, replica-major at each
step, so the dataset's draws are the JAX loader's; it reads only its own
replica's samples and replays the others' (their arrays memory-mapped,
not read). The sp ranks of a replica read the same batch. Samples whose
token count does not divide by the sp degree are skipped, as the JAX
iterator skips them.
Batches are stacked per key (string fields become lists); mixed-shape
caches are bucketed so every batch is shape-uniform. A resumed run does
not start at an offset, as the JAX trainers do: it replays the stream from
the start and drops the batches its steps took (``skip_batches``), so the
dataset's draws (captions, text drops, lose pairs), the shuffle's epochs
and the buckets come out as in an uninterrupted run.

With ``prefetch`` > 0 (the trainers' 2, as the JAX trainers read) a
background thread makes the batches, replay included, into a queue of
that many; the dataset and its random draws are touched by that thread
alone, in order, so the stream is the inline one. An exception in the
thread is raised in the consumer.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, Sequence

import numpy as np

from ..utils import tracing


class BlockDistributedSampler:
    """Replica ``rank``'s contiguous index block of ceil(dataset_len /
    num_replicas) indices (wrapping around the dataset's end), shuffled
    per epoch when asked; one replica's block is range(dataset_len)."""

    def __init__(self, dataset_len: int, shuffle: bool = False, seed: int = 0,
                 num_replicas: int = 1, rank: int = 0):
        if not 0 <= rank < num_replicas:
            raise ValueError(f"replica {rank} of {num_replicas}")
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.block = max(1, -(-dataset_len // num_replicas))

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self):
        return self.block

    def __iter__(self) -> Iterator[int]:
        lo = self.rank * self.block
        idxs = [(lo + i) % self.dataset_len for i in range(self.block)]
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


def latent_tokens(shape, patch=(1, 2, 2)) -> int:
    """The DiT's token count of a [F, H, W, C] latent."""
    f, h, w = shape[0], shape[1], shape[2]
    return (f // patch[0]) * (h // patch[1]) * (w // patch[2])


class BatchIterator:
    """Infinite, epoch-wrapping iterator of shape-uniform batches, less the
    first ``skip_batches``: those are replayed (``dataset.replay``, which
    maps the arrays rather than reading them) and dropped unstacked. With
    ``prefetch`` > 0 a daemon thread reads ahead up to ``prefetch``
    batches."""

    def __init__(self, dataset, sampler: BlockDistributedSampler, batch_size: int = 1,
                 skip_batches: int = 0, prefetch: int = 2, sp_size: int = 1,
                 replay_only: bool = False):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.skip_batches = skip_batches
        self.prefetch = prefetch
        self.sp_size = sp_size
        # another replica's stream: its draws happen, its batches are None
        self.replay_only = replay_only

    def __iter__(self):
        return _read_ahead(self._gen(), self.prefetch)

    def _sample_ok(self, sample) -> bool:
        lat = sample.get("latents")
        return (self.sp_size <= 1 or lat is None
                or latent_tokens(np.shape(lat)) % self.sp_size == 0)

    def _gen(self):
        epoch, skip = 0, self.skip_batches
        buckets: Dict[tuple, list] = {}
        while True:
            self.sampler.set_epoch(epoch)
            consumed = False
            for idx in self.sampler:
                replay = skip or self.replay_only
                sample = self.dataset.replay(idx) if replay else self.dataset[idx]
                if not self._sample_ok(sample):
                    continue
                consumed = True
                key = _shape_key(sample)
                buckets.setdefault(key, []).append(sample)
                if len(buckets[key]) == self.batch_size:
                    batch = buckets.pop(key)
                    if skip:
                        skip -= 1
                    else:
                        yield None if self.replay_only else stack_batch(batch)
            epoch += 1
            if not consumed:
                raise RuntimeError("the data stream made no progress in a full epoch")


def _read_ahead(gen, prefetch: int):
    """``gen``'s items, made up to ``prefetch`` ahead on a daemon thread
    named "BatchIterator" (inline without prefetch); an exception in the
    thread is raised in the consumer. The consumer counts its gets
    (``loader.get``), those that found the queue empty (``loader.empty``)
    and the nanoseconds it waited on them (``loader.wait_ns``) in the
    tracer's counters (utils/tracing.py)."""
    if prefetch <= 0:
        yield from gen
        return
    q = queue.Queue(maxsize=prefetch)

    def worker():
        try:
            for item in gen:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 -- raised again in the consumer
            q.put(e)

    threading.Thread(target=worker, daemon=True, name="BatchIterator").start()
    while True:
        tracing.count("loader.get")
        try:
            item = q.get_nowait()
        except queue.Empty:
            tracing.count("loader.empty")
            t0 = time.perf_counter_ns()
            item = q.get()
            tracing.count("loader.wait_ns", time.perf_counter_ns() - t0)
        if isinstance(item, BaseException):
            raise item
        yield item


class DataParallelLoader:
    """Replica ``rank``'s batches of ``num_replicas`` per-replica streams
    over one dataset, walked in the JAX DataParallelLoader's order (at each
    step replica 0's batch, then replica 1's, ...), so the dataset's draws
    come out as that loader's; only replica ``rank``'s samples are read,
    the others' replayed. One replica is a plain ``BatchIterator``."""

    def __init__(self, dataset, num_replicas: int = 1, rank: int = 0, batch_size: int = 1,
                 shuffle: bool = False, seed: int = 0, skip_batches: int = 0,
                 prefetch: int = 2, sp_size: int = 1):
        self.streams = [BatchIterator(
            dataset, BlockDistributedSampler(len(dataset), shuffle=shuffle, seed=seed,
                                             num_replicas=num_replicas, rank=r),
            batch_size=batch_size, skip_batches=skip_batches, prefetch=0, sp_size=sp_size,
            replay_only=r != rank) for r in range(num_replicas)]
        self.rank = rank
        self.prefetch = prefetch

    def _gen(self):
        gens = [s._gen() for s in self.streams]
        while True:
            batches = [next(g) for g in gens]
            yield batches[self.rank]

    def __iter__(self):
        return _read_ahead(self._gen(), self.prefetch)
