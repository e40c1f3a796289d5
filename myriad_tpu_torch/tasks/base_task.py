"""The base task (counterpart of ``myriad_tpu/tasks/base_task.py``): builds the
model and the datasets from the config, runs an epoch as
``iters_per_epoch`` training iterations of the runner, and evaluates a
split as the JAX task does: ``evaluation`` gathers ``valid_step``'s results
over the loader (``valid_step`` is left to a task), ``after_evaluation``
turns them into metrics (None here).  ``save_result`` writes each rank's
results and merges them on rank 0."""

from __future__ import annotations

import json
import logging
import os
from typing import Dict

import numpy as np

from myriad_tpu_torch.common import dist
from myriad_tpu_torch.common.config import get_model_class
from myriad_tpu_torch.common.logger import MetricLogger, SmoothedValue
from myriad_tpu_torch.common.profiling import StepTimer, device_memory_stats
from myriad_tpu_torch.datasets.builders import get_builder_class
from myriad_tpu_torch.models.layers import Policy


class BaseTask:
    def __init__(self, **kwargs):
        self.inst_id_key = "instance_id"
        self.timer = StepTimer()

    @classmethod
    def setup_task(cls, **kwargs):
        return cls()

    def build_model(self, cfg, device="cuda"):
        """The config's model (``model.arch``: ``myriad`` or ``mini_gpt4``)
        for training on ``device``: fp32 trainables and bf16 compute
        (``Policy.bf16``, the JAX package's default) unless the model section
        names a policy, and its trainables given ``requires_grad``; random
        weights from the section's ``seed``, then its ``weights:`` and
        ``ckpt:`` over them."""
        from myriad_tpu_torch.models.myriad import policy_from_config

        model_cfg = cfg.model_cfg
        policy = policy_from_config(model_cfg) or Policy.bf16()
        model = get_model_class(model_cfg.arch).from_config(model_cfg, device=device,
                                                            policy=policy, training=True)
        model.init_random(model_cfg.get("seed", 0))
        return model

    def build_datasets(self, cfg) -> Dict:
        datasets = {}
        for name, ds_cfg in cfg.datasets_cfg.items():
            datasets[name] = get_builder_class(name)(ds_cfg).build_datasets()
        if not datasets:
            raise ValueError("the config names no dataset: at least one is required")
        return datasets

    def train_epoch(self, epoch: int, runner, data_loader, iters_per_epoch: int,
                    log_freq: int = 50) -> Dict[str, str]:
        """``iters_per_epoch`` iterations; the phases ``data`` (the next batch)
        and ``step`` (the iteration, ending with the loss read on the host)
        are timed on ``self.timer`` across epochs.  The prompt and task
        stages are drawn from ``default_rng(base_seed + epoch)``, as the JAX
        package draws them.  The averages are summed over the ranks."""
        metric_logger = MetricLogger(delimiter="  ")
        metric_logger.add_meter("lr", SmoothedValue(window_size=1, fmt="{value:.6f}"))
        metric_logger.add_meter("loss", SmoothedValue(window_size=1, fmt="{value:.4f}"))
        header = f"Train: data epoch: [{epoch}]"
        logging.info("Start training epoch %d, %d iters per inner epoch.", epoch,
                     iters_per_epoch)
        rng = np.random.default_rng(runner.base_seed + epoch)
        for _ in metric_logger.log_every(range(iters_per_epoch), log_freq, header):
            with self.timer.phase("data"):
                samples = next(data_loader)
            with self.timer.phase("step"):
                loss, lr = runner.train_iteration(samples, rng)
            metric_logger.update(loss=loss, lr=lr)
        metric_logger.synchronize_between_processes()
        self.timer.log(f"phase timings to epoch {epoch}")
        mem = device_memory_stats(runner.device)
        if mem:
            logging.info("device memory: %.0f MiB peak", mem["peak_bytes_in_use_mib"])
        logging.info("Averaged stats: %s", metric_logger.global_avg())
        return {k: f"{meter.global_avg:.3f}" for k, meter in metric_logger.meters.items()}

    def evaluation(self, model, data_loader):
        """Every batch's ``valid_step`` results, in order."""
        metric_logger = MetricLogger(delimiter="  ")
        results = []
        for samples in metric_logger.log_every(data_loader, 10, "Evaluation"):
            results.extend(self.valid_step(model=model, samples=samples))
        dist.barrier("eval")
        return results

    def valid_step(self, model, samples):
        raise NotImplementedError

    def after_evaluation(self, val_result, split_name, epoch, **kwargs):
        return None

    @staticmethod
    def save_result(result, result_dir: str, filename: str, remove_duplicate: str = "") -> str:
        """Each data rank writes ``{filename}_rank{r}.json`` (under a model
        axis the model group's first rank: the group's ranks hold the same
        rows); rank 0 merges them in rank order into ``{filename}.json``,
        keeping the first item of each ``remove_duplicate`` key when one is
        named (the padded eval shares repeat rows); every rank returns the
        merged file's path once it is written."""
        os.makedirs(result_dir, exist_ok=True)
        if dist.is_data_writer():
            with open(os.path.join(result_dir, f"{filename}_rank{dist.get_data_rank()}.json"),
                      "w") as f:
                json.dump(result, f)
        dist.barrier("save_result")
        final_file = os.path.join(result_dir, f"{filename}.json")
        if dist.is_main_process():
            merged = []
            for rank in range(dist.get_data_world_size()):
                with open(os.path.join(result_dir, f"{filename}_rank{rank}.json")) as f:
                    merged += json.load(f)
            if remove_duplicate:
                seen, unique = set(), []
                for item in merged:
                    if item[remove_duplicate] not in seen:
                        seen.add(item[remove_duplicate])
                        unique.append(item)
                merged = unique
            with open(final_file, "w") as f:
                json.dump(merged, f)
            logging.info("result file saved to %s", final_file)
        dist.barrier("save_result_merge")
        return final_file
