"""The training loop (counterpart of ``myriad_tpu/runners/runner_base.py``).

One process on one device.  A training iteration is the model's
``prepare_train_arrays`` (the stage draws, the vision expert's maps, the
tokenised targets), ``train_loss`` and its backward through the trainables,
then ``AdamW.step`` (``common/optim.py``: the optax chain of
``make_optimizer``, gradient accumulation as ``optax.MultiSteps``).  The
loader halves the batch of an AnomalyDetection dataset, whose NSA twins
double it back; it shuffles the training split from the run's seed, drops
the last short batch and builds one batch ahead (``PrefetchLoader``).  Each
epoch ends with a save into the ``CheckpointManager`` ring (trainables by
name, the optimizer's state, epoch and global step); ``resume_ckpt_path``
restores one and continues from the epoch after it.  Validation splits and a
run that only evaluates are not ported and raise.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict

import numpy as np
import torch

from myriad_tpu_torch.checkpoint import CheckpointManager, load_checkpoint, merge_into
from myriad_tpu_torch.common import dist
from myriad_tpu_torch.common.optim import AdamW, build_schedule
from myriad_tpu_torch.datasets.loaders import DataLoader, IterLoader, PrefetchLoader


class RunnerBase:
    def __init__(self, cfg, task, model, datasets: Dict, job_id: str = "run"):
        self.config = cfg
        self.run_cfg = cfg.run_cfg
        self.task = task
        self.model = model
        self.datasets = datasets
        self.job_id = job_id
        self.device = model.device
        self.base_seed = int(self.run_cfg.get("seed", 42))
        self.seed = self.base_seed + dist.get_rank()
        self.max_epoch = int(self.run_cfg.get("max_epoch", 1))
        self.iters_per_epoch = int(self.run_cfg.get("iters_per_epoch", 100))
        self.accum_grad_iters = int(self.run_cfg.get("accum_grad_iters", 1))
        self.log_freq = int(self.run_cfg.get("log_freq", 50))
        self.batch_size_train = int(self.run_cfg.get("batch_size_train", 4))
        self.num_workers = int(self.run_cfg.get("num_workers", 4))
        if self.run_cfg.get("evaluate", False) or self.run_cfg.get("valid_splits"):
            raise NotImplementedError("evaluate / valid_splits: validation during training "
                                      "is not ported")
        self.output_dir = os.path.join(str(self.run_cfg.get("output_dir", "./output")), job_id)
        os.makedirs(self.output_dir, exist_ok=True)
        self.schedule = build_schedule(
            self.run_cfg.get("lr_sched", "linear_warmup_cosine_lr"),
            init_lr=float(self.run_cfg.get("init_lr", 1e-4)),
            min_lr=float(self.run_cfg.get("min_lr", 0.0)), max_epoch=self.max_epoch,
            iters_per_epoch=self.iters_per_epoch,
            warmup_steps=int(self.run_cfg.get("warmup_steps", 0)),
            warmup_start_lr=float(self.run_cfg.get("warmup_lr", -1)),
            decay_rate=float(self.run_cfg.get("lr_decay_rate", 1.0)))
        self.optimizer = AdamW(
            model.trainable_parameters(), self.schedule,
            weight_decay=float(self.run_cfg.get("weight_decay", 0.05)),
            beta2=float(self.run_cfg.get("beta2", 0.999)),
            max_grad_norm=self.run_cfg.get("max_grad_norm"),
            accum_grad_iters=self.accum_grad_iters,
            mu_dtype=self.run_cfg.get("optimizer_mu_dtype"))
        self._train_loader = None
        self.global_step = 0
        self.start_epoch = 0
        self.losses = []  # every iteration's loss, in order
        self.ckpt_manager = CheckpointManager(self.output_dir,
                                              int(self.run_cfg.get("max_checkpoints", -1)))
        resume = self.run_cfg.get("resume_ckpt_path")
        if resume:
            self._resume(resume)

    # -- data ------------------------------------------------------------------
    @property
    def train_loader(self):
        if self._train_loader is None:
            loaders = []
            shuffle = bool(self.run_cfg.get("shuffle_train", True))
            for name, splits in self.datasets.items():
                for split, dataset in splits.items():
                    if split != "train":
                        continue
                    bs = self.batch_size_train
                    if getattr(dataset, "DatasetName", "") == "AnomalyDetection":
                        bs = max(bs // 2, 1)  # the NSA twins double it back
                    dl = DataLoader(dataset, batch_size=bs, shuffle=shuffle, drop_last=True,
                                    num_workers=self.num_workers, seed=self.seed)
                    if bool(self.run_cfg.get("prefetch", True)):
                        dl = PrefetchLoader(dl)
                    loaders.append(IterLoader(dl))
            if len(loaders) != 1:
                raise NotImplementedError(f"{len(loaders)} training datasets: mixing datasets "
                                          "by sample_ratio is not ported")
            self._train_loader = loaders[0]
        return self._train_loader

    # -- the step ----------------------------------------------------------------
    def train_iteration(self, samples, rng: np.random.Generator):
        """One batch: forward, backward, optimizer.  Returns (loss, the rate of
        this global step) as host floats."""
        arrays, static = self.model.prepare_train_arrays(samples, rng)
        self.optimizer.zero_grad()
        loss = self.model.train_loss(arrays, static)
        loss.backward()
        self.optimizer.step()
        lr = float(self.schedule(self.global_step // max(self.accum_grad_iters, 1)))
        self.global_step += 1
        loss = float(loss.detach())
        self.losses.append(loss)
        return loss, lr

    # -- checkpoints -------------------------------------------------------------
    def _save_checkpoint(self, epoch, is_best: bool = False) -> str:
        state = {"model": {n: p.detach().cpu()
                           for n, p in self.model.trainable_state_dict().items()},
                 "optimizer": _to_cpu(self.optimizer.state_dict()),
                 "epoch": int(epoch), "global_step": int(self.global_step)}
        path = self.ckpt_manager.save("best" if is_best else epoch, state)
        logging.info("Saved checkpoint at epoch %d to %s", epoch, path)
        return path

    def _resume(self, path: str) -> None:
        state = load_checkpoint(path)
        loaded, _ = merge_into(self.model.trainable_state_dict(), state["model"])
        if "optimizer" in state:
            self.optimizer.load_state_dict(state["optimizer"])
        self.start_epoch = int(state["epoch"]) + 1
        self.global_step = int(state["global_step"])
        logging.info("Resumed from %s (epoch %d, %d tensors)", path, self.start_epoch,
                     len(loaded))

    def log_stats(self, stats: Dict, split_name: str = "train") -> None:
        with open(os.path.join(self.output_dir, "log.txt"), "a") as f:
            f.write(json.dumps({f"{split_name}_{k}": v for k, v in stats.items()}) + "\n")

    def log_config(self) -> None:
        with open(os.path.join(self.output_dir, "log.txt"), "a") as f:
            f.write(json.dumps(self.config.to_dict(), default=str) + "\n")

    # -- the loop ------------------------------------------------------------------
    def train(self) -> None:
        start = time.time()
        self.log_config()
        loader = self.train_loader
        try:
            for epoch in range(self.start_epoch, self.max_epoch):
                stats = self.task.train_epoch(epoch, self, loader, self.iters_per_epoch,
                                              self.log_freq)
                self.log_stats(stats, "train")
                self._save_checkpoint(epoch)
                dist.barrier(f"epoch_{epoch}")
        finally:
            loader.close()
        total = time.time() - start
        logging.info("Training time %s", time.strftime("%H:%M:%S", time.gmtime(total)))


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    return tree
