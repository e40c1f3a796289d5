"""A map-style loader (counterpart of ``DataLoader`` in
``myriad_tpu/datasets/loaders.py``): batches in index order, collated by the
dataset's ``collater``, built by a thread pool that keeps ``2 * num_workers``
batches in flight."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator


class DataLoader:
    def __init__(self, dataset, batch_size: int, num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def _fetch(self, indices):
        return self.dataset.collater([self.dataset[i] for i in indices])

    def __iter__(self) -> Iterator:
        n = len(self.dataset)
        batches = [range(i, min(i + self.batch_size, n)) for i in range(0, n, self.batch_size)]
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
