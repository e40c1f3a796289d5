"""Windowed metric logging (counterpart of ``myriad_tpu/common/logger.py``).

``SmoothedValue`` tracks a deque window and a global sum and count;
``MetricLogger.log_every`` logs the iteration time, data time and ETA.
``synchronize_between_processes`` sums each meter's count and total over the
ranks (``dist.all_sum_scalars``), so the global averages are the job's.
"""

from __future__ import annotations

import datetime
import logging
import time
from collections import defaultdict, deque
from typing import Iterable, Iterator, Optional

import numpy as np

from myriad_tpu_torch.common import dist


class SmoothedValue:
    """Track a series of values; expose window and global averages."""

    def __init__(self, window_size: int = 20, fmt: Optional[str] = None):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt or "{median:.4f} ({global_avg:.4f})"

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self) -> None:
        """Sum the count and total over the data-parallel ranks (the window
        stays local)."""
        if dist.get_data_world_size() <= 1:
            return
        count, total = dist.all_sum_scalars(float(self.count), self.total)
        self.count = int(count)
        self.total = total

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(
            median=self.median,
            avg=self.avg,
            global_avg=self.global_avg,
            max=self.max,
            value=self.value,
        )


class MetricLogger:
    def __init__(self, delimiter: str = "\t"):
        self.meters: dict = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def add_meter(self, name: str, meter: SmoothedValue) -> None:
        self.meters[name] = meter

    def __getattr__(self, attr: str):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(f"'MetricLogger' object has no attribute '{attr}'")

    def synchronize_between_processes(self) -> None:
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def global_avg(self) -> str:
        return self.delimiter.join(
            f"{name}: {meter.global_avg:.4f}" for name, meter in self.meters.items()
        )

    def __str__(self) -> str:
        return self.delimiter.join(f"{name}: {meter}" for name, meter in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int, header: str = "") -> Iterator:
        i = 0
        start_time = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)  # type: ignore[arg-type]
        except TypeError:
            total = None
        space_fmt = ":" + str(len(str(total or 0))) + "d"
        log_msg = [header, "[{0" + space_fmt + "}/{1}]", "eta: {eta}", "{meters}",
                   "time: {time}", "data: {data}"]
        log_msg = self.delimiter.join(log_msg)
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total is not None and i == total - 1):
                if total is not None:
                    eta_seconds = iter_time.global_avg * (total - i)
                    eta_string = str(datetime.timedelta(seconds=int(eta_seconds)))
                else:
                    eta_string = "?"
                logging.info(
                    log_msg.format(
                        i, total if total is not None else "?",
                        eta=eta_string, meters=str(self),
                        time=str(iter_time), data=str(data_time),
                    )
                )
            i += 1
            end = time.time()
        total_time = time.time() - start_time
        total_time_str = str(datetime.timedelta(seconds=int(total_time)))
        per_it = total_time / max(i, 1)
        logging.info(f"{header} Total time: {total_time_str} ({per_it:.4f} s / it)")


def setup_logger(level: int = logging.INFO) -> None:
    """INFO on the main process, WARN elsewhere (reference logger.py:190-195)."""
    logging.basicConfig(
        level=level if dist.is_main_process() else logging.WARN,
        format="%(asctime)s [%(levelname)s] %(message)s",
        force=True,
    )
