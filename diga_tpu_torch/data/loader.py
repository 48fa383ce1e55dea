"""Threaded host batch loader over a ``SegDataset``.

The port's own copy of ``diga_tpu/data/pipeline.py::BatchLoader`` (:23-110)
with ``EpochShuffleSampler`` and ``collate`` from
``diga_tpu/data/datasets.py`` (:266-331).  PIL/numpy decode releases the
interpreter lock for most of its work, so threads make an effective
worker pool.  Every sample's augmentation draws come from a numpy
``Generator`` keyed by (seed, stream position), so a batch's pixels do
not depend on the worker count.

Host sharding (``pipeline.py:57-82``): global batch b spans stream
positions [b·Bg, (b+1)·Bg) with Bg = ``batch_size`` · ``host_count``, and
host h builds the contiguous rows from b·Bg + h·``batch_size``.  The
hosts' batches concatenated in host order are the one-host batch of
``batch_size`` · ``host_count``, bit for bit, for any worker count.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence

import numpy as np

from .datasets import SegDataset


class EpochShuffleSampler:
    """Position -> dataset index: epoch p // n, slot p % n of that epoch's
    permutation drawn from (seed, epoch).  ``host_id``/``host_count`` are
    kept for introspection, as JAX's: ``BatchLoader`` does the sharding."""

    def __init__(self, n: int, seed: int = 0, host_id: int = 0, host_count: int = 1):
        self.n = n
        self.seed = seed
        self.host_id = host_id
        self.host_count = host_count
        self._orders: dict[int, np.ndarray] = {}
        self._lock = threading.Lock()

    def _order(self, epoch: int) -> np.ndarray:
        with self._lock:
            order = self._orders.get(epoch)
            if order is None:
                order = np.arange(self.n)
                np.random.default_rng((self.seed, epoch)).shuffle(order)
                self._orders = {epoch: order}  # keep only the current epoch
            return order

    def index_at(self, position: int) -> int:
        epoch, slot = divmod(position, self.n)
        return int(self._order(epoch)[slot])


def collate(samples: Sequence[dict]) -> dict:
    """Stack sample dicts into batched numpy arrays (labels and pseudo-labels
    -> int32)."""
    out = {"image": np.stack([s["image"] for s in samples]).astype(np.float32),
           "label": np.stack([s["label"] for s in samples]).astype(np.int32)}
    if "pseudo" in samples[0]:
        out["pseudo"] = np.stack([s["pseudo"] for s in samples]).astype(np.int32)
    out["name"] = [s["name"] for s in samples]
    return out


class BatchLoader:
    """Infinite batches of ``batch_size`` samples, built by worker threads
    and yielded in order.  A worker that fails hands its exception on in
    place of the batch, and the consumer raises it there."""

    def __init__(self, dataset: SegDataset, batch_size: int, seed: int = 0,
                 num_workers: int = 4, prefetch: int = 4, host_id: int = 0,
                 host_count: int = 1):
        if not 0 <= host_id < host_count:
            raise ValueError(f"host_id {host_id} of host_count {host_count}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.host_id = host_id
        self.host_count = host_count
        self.sampler = EpochShuffleSampler(len(dataset), seed=seed, host_id=host_id,
                                           host_count=host_count)
        self.num_workers = max(1, num_workers)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    def _producer(self, worker_id: int) -> None:
        bg = self.batch_size * self.host_count
        base = self.host_id * self.batch_size
        batch_idx = worker_id
        while not self._stop.is_set():
            positions = [batch_idx * bg + base + j for j in range(self.batch_size)]
            try:
                samples = [self.dataset.__getitem__(self.sampler.index_at(p),
                                                    rng=np.random.default_rng((self.seed, p)))
                           for p in positions]
                item = (batch_idx, collate(samples))
            except Exception as e:  # handed to the consumer, which raises it
                item = (batch_idx, e)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=1.0)
                    break
                except queue.Full:
                    continue
            if isinstance(item[1], Exception):
                return
            batch_idx += self.num_workers

    def start(self) -> None:
        if self._threads:
            return
        for w in range(self.num_workers):
            t = threading.Thread(target=self._producer, args=(w,), daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=60.0)

    def __iter__(self) -> Iterator[dict]:
        self.start()
        pending: dict[int, dict] = {}
        want = 0
        while True:
            while want not in pending:
                idx, batch = self._q.get()
                pending[idx] = batch
            batch = pending.pop(want)
            if isinstance(batch, Exception):
                raise RuntimeError(f"a loader worker failed on batch {want}") from batch
            yield batch
            want += 1
