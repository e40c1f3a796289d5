"""The training loop (counterpart of ``myriad_tpu/runners/runner_base.py``).

One process on one device.  A training iteration is the model's
``prepare_train_arrays`` (the stage draws, the vision expert's maps, the
tokenised targets), ``train_loss`` and its backward through the trainables,
then ``AdamW.step`` (``common/optim.py``: the optax chain of
``make_optimizer``, gradient accumulation as ``optax.MultiSteps``).  The
loader halves the batch of an AnomalyDetection dataset, whose NSA twins
double it back; it shuffles the training split from the run's seed, drops
the last short batch and builds one batch ahead (``PrefetchLoader``).  A
stream without ``__len__`` (tar shards) is batched by ``IterableBatcher``,
and several training datasets are mixed by their ``sample_ratio``
(``MultiIterLoader``).  After
an epoch's training each of ``valid_splits`` is evaluated by the task
(``evaluation`` then ``after_evaluation``); the first split's best
``agg_metrics`` is saved as ``checkpoint_best``, and ``evaluate: True``
trains nothing, saves nothing and stops after one epoch, as in the JAX
runner.  Each trained epoch ends with a save into the ``CheckpointManager``
ring: the JAX runner's state, ``{"model": the trainables as the JAX tree,
"optimizer": the optax state, "epoch", "global_step"}``, as an Orbax
directory the JAX package resumes.  ``resume_ckpt_path`` takes such a
directory (written by either package), the port's earlier ``.pth`` ring
files, or a parameter file, and continues from the epoch after it; the
optimizer's state is matched by name (``AdamW.load_optax_tree``).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict

import numpy as np
import torch

from myriad_tpu_torch import checkpoint as ckpt_lib
from myriad_tpu_torch.checkpoint import CheckpointManager
from myriad_tpu_torch.common import dist
from myriad_tpu_torch.common.optim import AdamW, build_schedule
from myriad_tpu_torch.convert_from_jax import jax_leaves, tree_of
from myriad_tpu_torch.datasets.loaders import (DataLoader, IterableBatcher, IterLoader,
                                               MultiIterLoader, PrefetchLoader)


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
        self._train_loaders = None
        self._train_ratios = []
        self.global_step = 0
        self.start_epoch = 0
        self.losses = []  # every iteration's loss, in order
        self.ckpt_manager = CheckpointManager(self.output_dir,
                                              int(self.run_cfg.get("max_checkpoints", -1)))
        resume = self.run_cfg.get("resume_ckpt_path")
        if resume:
            self._resume(resume)

    # -- data ------------------------------------------------------------------
    def _build_train_loaders(self):
        """One endless loader per training dataset, and its ``sample_ratio``
        (1 when unset): an ``IterableBatcher`` over a stream without
        ``__len__``, else the shuffled map-style loader, built ahead."""
        loaders, ratios = [], []
        shuffle = bool(self.run_cfg.get("shuffle_train", True))
        for name, splits in self.datasets.items():
            for split, dataset in splits.items():
                if split != "train":
                    continue
                bs = self.batch_size_train
                if getattr(dataset, "DatasetName", "") == "AnomalyDetection":
                    bs = max(bs // 2, 1)  # the NSA twins double it back
                ratios.append(float(getattr(dataset, "sample_ratio", 1.0) or 1.0))
                if not hasattr(dataset, "__len__"):
                    loaders.append(IterableBatcher(dataset, bs))
                    continue
                dl = DataLoader(dataset, batch_size=bs, shuffle=shuffle, drop_last=True,
                                num_workers=self.num_workers, seed=self.seed)
                if bool(self.run_cfg.get("prefetch", True)):
                    dl = PrefetchLoader(dl)
                loaders.append(IterLoader(dl))
        if not loaders:
            raise ValueError("no dataset has a train split")
        return loaders, ratios

    @property
    def train_loader(self):
        """The training batches: the one loader, or, with several datasets, a
        ``MultiIterLoader`` over them by ``sample_ratio`` (``_train_ratios``),
        drawn from ``default_rng(self.seed)`` and built anew at each read, as
        the JAX runner's property builds it."""
        if self._train_loaders is None:
            self._train_loaders, self._train_ratios = self._build_train_loaders()
        if len(self._train_loaders) == 1:
            return self._train_loaders[0]
        return MultiIterLoader(self._train_loaders, ratios=self._train_ratios, seed=self.seed)

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
    def _to_tree(self, tensors: Dict[str, torch.Tensor]) -> Dict:
        return tree_of(self.model.module, tensors)

    @staticmethod
    def _from_tree(tree) -> Dict[str, torch.Tensor]:
        return {name: t for _, name, t in jax_leaves(tree)}

    def _save_checkpoint(self, epoch, is_best: bool = False) -> str:
        state = {"model": self._to_tree(self.model.trainable_state_dict()),
                 "optimizer": self.optimizer.optax_tree(self._to_tree),
                 "epoch": np.asarray(epoch), "global_step": np.asarray(self.global_step)}
        path = self.ckpt_manager.save("best" if is_best else epoch, state)
        logging.info("Saved checkpoint at epoch %d to %s", epoch, path)
        return path

    def _resume(self, path: str) -> None:
        """Restore a ring checkpoint: an Orbax directory (the JAX runner's
        state), one of the port's earlier ``.pth`` files, or, as the JAX
        runner reads any other file, a parameter tree alone."""
        trainables = self.model.trainable_state_dict()
        if os.path.isdir(path) or not ckpt_lib.is_port_checkpoint(path):
            state = (ckpt_lib.load_params(path) if os.path.isdir(path)
                     else {"model": ckpt_lib.load_params(path)})
            loaded, _ = ckpt_lib.merge_with_paths(trainables, state["model"])
            if "optimizer" in state:
                self.optimizer.load_optax_tree(state["optimizer"], self._from_tree)
        else:
            state = ckpt_lib.load_checkpoint(path)
            loaded, _ = ckpt_lib.merge_into(trainables, state["model"])
            self.optimizer.load_state_dict(state["optimizer"])
        if "epoch" in state:
            self.start_epoch = int(state["epoch"]) + 1
        if "global_step" in state:
            self.global_step = int(state["global_step"])
        logging.info("Resumed from %s (epoch %d, %d tensors)", path, self.start_epoch,
                     len(loaded))

    def log_stats(self, stats: Dict, split_name: str = "train") -> None:
        with open(os.path.join(self.output_dir, "log.txt"), "a") as f:
            f.write(json.dumps({f"{split_name}_{k}": v for k, v in stats.items()}) + "\n")

    def log_config(self) -> None:
        with open(os.path.join(self.output_dir, "log.txt"), "a") as f:
            f.write(json.dumps(self.config.to_dict(), default=str) + "\n")

    # -- validation ----------------------------------------------------------------
    @property
    def valid_splits(self):
        return list(self.run_cfg.get("valid_splits", []))

    def eval_loader(self, split_name: str):
        """A loader over the datasets' ``split_name`` split, in order, the last
        short batch kept; None when no dataset has the split."""
        for splits in self.datasets.values():
            dataset = splits.get(split_name)
            if dataset is not None:
                bs = self.batch_size_train
                if getattr(dataset, "DatasetName", "") == "AnomalyDetection":
                    bs = max(bs // 2, 1)
                return DataLoader(dataset, batch_size=bs, shuffle=False, drop_last=False,
                                  num_workers=self.num_workers, seed=self.seed)
        return None

    def eval_epoch(self, split_name: str, epoch):
        loader = self.eval_loader(split_name)
        if loader is None:
            logging.warning("no dataloader for split %s", split_name)
            return None
        results = self.task.evaluation(self.model, loader)
        if results is None:
            return None
        return self.task.after_evaluation(val_result=results, split_name=split_name,
                                          epoch=epoch)

    # -- the loop ------------------------------------------------------------------
    def train(self) -> None:
        start = time.time()
        self.log_config()
        best_agg = -1.0
        evaluate_only = bool(self.run_cfg.get("evaluate", False))
        loader = self.train_loader
        try:
            for epoch in range(self.start_epoch, self.max_epoch):
                if not evaluate_only:
                    stats = self.task.train_epoch(epoch, self, loader, self.iters_per_epoch,
                                                  self.log_freq)
                    self.log_stats(stats, "train")
                for split in self.valid_splits:
                    logging.info("Evaluating on %s", split)
                    metrics = self.eval_epoch(split, epoch)
                    if metrics is not None:
                        agg = float(metrics.get("agg_metrics", -1.0))
                        if split == self.valid_splits[0] and agg > best_agg:
                            best_agg = agg
                            self._save_checkpoint(epoch, is_best=True)
                        self.log_stats(metrics, split)
                if not evaluate_only:
                    self._save_checkpoint(epoch)
                dist.barrier(f"epoch_{epoch}")
                if evaluate_only:
                    break
        finally:
            loader.close()
        total = time.time() - start
        logging.info("Training time %s", time.strftime("%H:%M:%S", time.gmtime(total)))
