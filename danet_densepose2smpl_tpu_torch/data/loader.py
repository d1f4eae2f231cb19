"""Deterministic, mid-epoch-resumable batch loader (port of the JAX
package's `data/loader.py`, reference `utils/data_loader.py`).

Each epoch draws a permutation that is a pure function of (seed, epoch),
and each sample's augmentation RNG is a pure function of (seed, epoch,
batch, slot), so a checkpoint stores only (epoch, batch_idx) and a resumed
run replays the remaining batches exactly. `PrefetchLoader` assembles the
next batches on a producer thread with decode threads while the card runs
the current step; its batches are byte-identical to the wrapped loader's.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def _collate(items: list) -> dict:
    """Stack a list of sample dicts into batched numpy arrays (strings stay
    lists, nested dicts recurse). Arrays of one key must share a shape:
    raw frames (`NpzDataset(return_raw=True)`, `--device_preprocess`) of
    different sizes raise a ValueError that says so."""
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if isinstance(vals[0], dict):
            out[k] = _collate(vals)
        elif isinstance(vals[0], str):
            out[k] = vals
        else:
            arrays = [np.asarray(v) for v in vals]
            shapes = sorted({a.shape for a in arrays})
            if len(shapes) > 1:
                raise ValueError(
                    f"cannot batch '{k}': its samples have shapes {shapes}. Raw frames "
                    "(NpzDataset(return_raw=True), the --device_preprocess path) are cropped on the "
                    "card as one batch, so every frame of a dataset must have the same size; "
                    "run without --device_preprocess to crop frames of mixed sizes on the host")
            out[k] = np.stack(arrays)
    return out


class ResumableLoader:
    """Iterates dataset batches with deterministic shuffling.

    dataset: indexable with `__getitem__(i, rng=...)` and `__len__`.
    `shard_id` / `num_shards` slice each batch for one of several hosts.
    `rows` (a slice of a batch's slots) keeps only those samples of each
    batch, each assembled as it is in the whole batch (the same sample and
    RNG): a data-parallel rank's rows of the global batch, bit for bit.
    """

    def __init__(self, dataset, batch_size: int, seed: int = 0, shuffle: bool = True,
                 drop_last: bool = True, shard_id: int = 0, num_shards: int = 1,
                 rows: slice | None = None):
        if batch_size % num_shards:
            raise ValueError(f"batch_size {batch_size} is not a multiple of num_shards {num_shards}")
        self.rows = rows
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.shard_id = shard_id
        self.num_shards = num_shards

    def num_batches(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def permutation(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState((self.seed * 100003 + epoch) % (2**31)).shuffle(idx)
        return idx

    def _fetch(self, epoch: int, b: int, perm: np.ndarray, pool=None) -> dict:
        """Assemble batch `b`, optionally decoding its samples on a thread
        pool; the per-sample RNG is the same either way."""
        shard = self.batch_size // self.num_shards
        lo = b * self.batch_size + self.shard_id * shard
        ids = perm[lo : lo + shard]

        def get(pair):
            slot, i = pair
            rng = np.random.RandomState(
                (self.seed * 92821 + epoch * 524287 + b * 1031 + self.shard_id * 97 + slot) % (2**31)
            )
            return self.dataset.__getitem__(int(i), rng=rng)

        pairs = list(enumerate(ids))
        if self.rows is not None:
            pairs = pairs[self.rows]
        items = list(pool.map(get, pairs)) if pool is not None else [get(p) for p in pairs]
        return _collate(items)

    def epoch(self, epoch: int, start_batch: int = 0):
        """Yield (batch_idx, batch dict) from `start_batch` (mid-epoch resume)."""
        perm = self.permutation(epoch)
        for b in range(start_batch, self.num_batches()):
            yield b, self._fetch(epoch, b, perm)


class PrefetchLoader:
    """Double-buffered wrapper over a ResumableLoader: a producer thread
    assembles up to `depth` upcoming batches with `workers` decode threads
    (numpy and zlib release the GIL for most of a decode). An exception in
    the producer is raised in the consumer; a consumer that stops early
    (break, exception, garbage collection) stops the producer and drains
    the queue before the generator closes."""

    def __init__(self, loader: ResumableLoader, depth: int = 2, workers: int | None = None):
        self.loader = loader
        self.depth = depth
        if workers is None:
            # core-count-aware default: decode threads beyond the spare
            # cores thrash; one producer thread still overlaps decode with
            # the step
            workers = max(1, min(4, (os.cpu_count() or 1) - 1))
        self.workers = workers

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def epoch(self, epoch: int, start_batch: int = 0):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        done = object()

        def produce():
            try:
                perm = self.loader.permutation(epoch)
                with ThreadPoolExecutor(self.workers) as pool:
                    for b in range(start_batch, self.loader.num_batches()):
                        if stop.is_set():
                            return
                        q.put((b, self.loader._fetch(epoch, b, perm, pool)))
            except BaseException as e:  # handed to the consumer, which raises it
                q.put(e)
            finally:
                q.put(done)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
