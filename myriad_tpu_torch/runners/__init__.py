"""Runners (counterpart of ``myriad_tpu/runners``)."""

from myriad_tpu_torch.runners.runner_base import RunnerBase

RUNNERS = {"runner_base": RunnerBase}

__all__ = ["RUNNERS", "RunnerBase"]
