"""Multiprocess training data loader (a copy of
``monoport_tpu/training/datasets/loader.py``).

Reference contract: the forked DataLoader's worker processes + pin-memory
thread (RTL/dataloader.py:697-730; cfg.num_threads, common/config.py:20)
— dataset items are fetched in worker processes while the accelerator
trains, with dead-worker detection (:772-809).

Workers produce numpy batches (they are forked, and a forked process must
not touch CUDA); a background thread drains the pool into a bounded queue
and the training loop moves each batch to the device in the main process.
Worker death surfaces as a RuntimeError naming
the stage, matching the reference's failure mode.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import threading
from typing import Iterator, Sequence

import numpy as np

_worker_dataset = None


def _init_worker(dataset_factory, factory_args):
    global _worker_dataset
    _worker_dataset = dataset_factory(*factory_args)


def _fetch(indices: Sequence[int]) -> dict:
    items = [_worker_dataset[int(i)] for i in indices]
    return {k: np.stack([it[k] for it in items]) for k in items[0]
            if not isinstance(items[0][k], str)}


class DataLoader:
    """Iterate batches of ``dataset_factory(*factory_args)`` items.

    The dataset is constructed inside each worker (picklable factory
    instead of pickling the dataset object), mirroring how the reference's
    workers each hold their own dataset handle.
    """

    def __init__(self, dataset_factory, factory_args=(), length: int = 0,
                 batch_size: int = 4, num_workers: int = 2,
                 shuffle: bool = True, seed: int = 0, prefetch: int = 4,
                 drop_last: bool = True):
        self.factory = dataset_factory
        self.factory_args = tuple(factory_args)
        self.length = length or len(dataset_factory(*factory_args))
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = self.length // self.batch_size
        return n if self.drop_last else -(-self.length // self.batch_size)

    def _index_batches(self, epoch: int):
        idx = np.arange(self.length)
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(idx)
        stop = (self.length // self.batch_size) * self.batch_size \
            if self.drop_last else self.length
        for s in range(0, stop, self.batch_size):
            yield idx[s:s + self.batch_size]

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        if self.num_workers <= 0:
            _init_worker(self.factory, self.factory_args)
            for indices in self._index_batches(epoch):
                yield _fetch(indices)
            return

        ctx = mp.get_context("fork")
        pool = ctx.Pool(self.num_workers, initializer=_init_worker,
                        initargs=(self.factory, self.factory_args))
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        _SENTINEL = object()

        def producer():
            try:
                for batch in pool.imap(_fetch, self._index_batches(epoch)):
                    out_q.put(batch)
                out_q.put(_SENTINEL)
            except BaseException as exc:  # noqa: BLE001
                out_q.put(RuntimeError(
                    f"DataLoader worker failed: {exc!r}"))

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is _SENTINEL:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            pool.terminate()
            pool.join()
