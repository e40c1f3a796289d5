"""Data loading (counterpart of ``myriad_tpu/datasets/loaders.py``).

``DataLoader`` is map-style: batches of indices (shuffled by
``default_rng(seed + epoch)`` when ``shuffle``, the last short batch dropped
when ``drop_last``), collated by the dataset's ``collater``, built by a
thread pool that keeps ``2 * num_workers`` batches in flight.  ``IterLoader``
wraps it into an endless iterator that starts the next epoch when one ends;
``PrefetchLoader`` builds batches ahead of the consumer in a background
thread.  NSA synthesis and PNG decoding run in
numpy, scipy and zlib, which release the GIL for most of their time.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np


class DataLoader:
    def __init__(self, dataset, batch_size: int, num_workers: int = 0, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 collate_fn: Optional[Callable] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn or dataset.collater
        self._seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self._seed + self._epoch).shuffle(idx)
        return idx

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _fetch(self, indices):
        return self.collate_fn([self.dataset[int(i)] for i in indices])

    def __iter__(self) -> Iterator:
        idx = self._indices()
        batches = [idx[i:i + self.batch_size] for i in range(0, len(idx), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        if self.num_workers <= 0:
            for b in batches:
                yield self._fetch(b)
            return
        with ThreadPoolExecutor(self.num_workers) as pool:
            futures = [pool.submit(self._fetch, b) for b in batches[: 2 * self.num_workers]]
            for i in range(len(batches)):
                yield futures[i].result()
                futures[i] = None
                if len(futures) < len(batches):
                    futures.append(pool.submit(self._fetch, batches[len(futures)]))


class IterLoader:
    """An endless iterator over a loader's epochs."""

    def __init__(self, dataloader):
        self._dataloader = dataloader
        self._epoch = 0
        self._iter = iter(dataloader)

    def __next__(self):
        try:
            return next(self._iter)
        except StopIteration:
            self._epoch += 1
            if hasattr(self._dataloader, "set_epoch"):
                self._dataloader.set_epoch(self._epoch)
            self._iter = iter(self._dataloader)
            try:
                return next(self._iter)
            except StopIteration:
                raise RuntimeError("IterLoader: the loader yields no batches (a dataset "
                                   "smaller than the batch, with drop_last?)") from None

    def __iter__(self):
        return self

    def __len__(self):
        return len(self._dataloader)

    def close(self) -> None:
        """Stop the current epoch's iterator (and a prefetch thread under it)."""
        close = getattr(self._iter, "close", None)
        if close is not None:
            close()


class PrefetchLoader:
    """A background thread builds the loader's batches ``depth`` ahead."""

    def __init__(self, loader, depth: int = 2):
        self.loader = loader
        self.depth = depth

    def __len__(self):
        return len(self.loader)

    # no set_epoch, as in the JAX package: an IterLoader over a PrefetchLoader
    # restarts the inner loader at its first epoch's permutation every epoch

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = object()
        error: list = []
        done = threading.Event()

        def worker():
            try:
                for batch in self.loader:
                    while not done.is_set():
                        try:
                            q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if done.is_set():
                        return
            except BaseException as e:  # raised again in the consumer's thread
                error.append(e)
            finally:
                if not done.is_set():
                    q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    if error:
                        raise error[0]
                    break
                yield item
        finally:
            done.set()
