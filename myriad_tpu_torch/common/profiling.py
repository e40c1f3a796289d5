"""Step phase timings and device memory (counterpart of
``myriad_tpu/common/profiling.py``).

``StepTimer`` accumulates host-clock time per named phase of the training
loop (``data``: the next batch from the loader; ``step``: the training
iteration, which ends with a host read of the loss, so it holds the card's
time too).  ``device_memory_stats`` reads torch's allocator on the card.
"""

from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from typing import Dict, Iterator, List

import torch


class StepTimer:
    """Named phase timings per step (``history``: each phase's seconds, in order)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.history: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            self.history[name].append(dt)

    def summary(self) -> Dict[str, float]:
        return {name: self.totals[name] / max(self.counts[name], 1) for name in self.totals}

    def log(self, prefix: str = "phase timings") -> None:
        parts = ", ".join(f"{k}: {v * 1e3:.1f}ms" for k, v in self.summary().items())
        logging.info("%s: %s", prefix, parts)


def device_memory_stats(device=None) -> Dict[str, float]:
    """Current and peak memory that torch allocated on the card, MiB ({} off it)."""
    if not torch.cuda.is_available() or (device is not None
                                         and torch.device(device).type != "cuda"):
        return {}
    mib = 1024 * 1024
    return {"bytes_in_use_mib": torch.cuda.memory_allocated(device) / mib,
            "peak_bytes_in_use_mib": torch.cuda.max_memory_allocated(device) / mib}
