"""The training loop (counterpart of ``myriad_tpu/runners/runner_base.py``).

One process a device; under a launcher, data parallel over the ranks
(``common/dist.py``).  A training iteration is the model's
``prepare_train_arrays`` (the stage draws, the vision expert's maps, the
tokenised targets), ``train_nll`` and the backward of the loss through the
trainables, then ``AdamW.step`` (``common/optim.py``: the optax chain of
``make_optimizer``, gradient accumulation as ``optax.MultiSteps``).

Across ranks the loss is the JAX package's over the global batch, the nll
summed over every rank's answer tokens over their global count
(``myriad_tpu/models/llama.py::lm_cross_entropy`` reduced by GSPMD; the
port's ``lm_nll`` gives the parts), not the mean of the ranks' means, which
differs when ranks hold different numbers of tokens.  Each rank sums its (nll, count) with the others' (one
collective), backpropagates its own nll over the global count, and the
trainables' gradients are summed over the ranks in one flat buffer
(``dist.all_sum_``): the gradient of the global token mean on every rank,
the same bits, before clipping and AdamW, so the trainables stay
bit-identical.  ``DistributedDataParallel`` with the loss scaled by
``world / global count`` gives the same gradient, but it hooks a module's
``forward`` (the runner calls ``forward_train`` through the host model) and
broadcasts every parameter of the module when it wraps it, the frozen
towers included.  The reported loss is the global one, the same on every
rank.

The loader halves the batch of an AnomalyDetection dataset, whose NSA twins
double it back; it shuffles the training split from the run's seed, drops
the last short batch and builds one batch ahead (``PrefetchLoader``).
Under a world above 1 each map-style split takes a ``DistributedSampler``
(one permutation from ``base_seed`` on every rank, the rank's strided
share; the eval splits padded and in order), while host work with a rank of
its own (worker seeds, ``MultiIterLoader``) takes ``base_seed + rank``.  A
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
optimizer's state is matched by name (``AdamW.load_optax_tree``).  Rank 0
alone makes ``output_dir``, writes ``log.txt`` and writes the ring (every
rank calls the save, which barriers around rank 0's write); every rank
reads ``resume_ckpt_path``.

With ``model_shards: n`` > 1 (and ``use_mesh``, true by default then) the
runner trains over a (data, model) mesh, as the JAX runner's ``_place_model``
shards its trees over ``make_mesh(n_model=n)``: model groups of n
consecutive ranks each hold the LLaMA's shards (``parallel.mesh.make_mesh``,
``Myriad.shard``; ``train.py`` builds both before the runner, which does it
itself for a model given whole), and the data groups across them split the
batch.  The sampler, the host seeds and every sum above follow the data
rank and the data group (``common.dist``'s data axis), so each model group
is counted once.  The ranks of a group feed bit-identical arrays: the
group's first rank prepares them (the stage draws, the vision expert's
maps, the NSA twins its loader made) and broadcasts them.  It alone runs
the towers, so after the backward the towers' trainables have a gradient
there only: the replicated trainables' gradients are summed over the world
in one buffer, the group's first rank adding its gradient and the others
zeros, except where each rank holds a part (``partition.partial_grad``:
``lora_a``), which every rank adds; the shards' gradients are summed over
the data group.  ``clip_by_global_norm`` counts each shard's squares over
the group (``AdamW``).  The ring is written whole:
the shards of the trainables and of Adam's ``mu``/``nu`` are gathered over
the model group and rank 0 writes the JAX runner's layout, so a ring
written under a mesh resumes on one process and a one-process ring on a
mesh (``_resume`` cuts each whole tensor to the rank's piece).
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
from myriad_tpu_torch.datasets.loaders import (DataLoader, DistributedSampler,
                                               IterableBatcher, IterLoader, MultiIterLoader,
                                               PrefetchLoader)
from myriad_tpu_torch.parallel import partition
from myriad_tpu_torch.parallel.mesh import make_mesh


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
        self.mesh = self._model_mesh(model)
        self.seed = self.base_seed + dist.get_data_rank()
        self.max_epoch = int(self.run_cfg.get("max_epoch", 1))
        self.iters_per_epoch = int(self.run_cfg.get("iters_per_epoch", 100))
        self.accum_grad_iters = int(self.run_cfg.get("accum_grad_iters", 1))
        self.log_freq = int(self.run_cfg.get("log_freq", 50))
        self.batch_size_train = int(self.run_cfg.get("batch_size_train", 4))
        self.num_workers = int(self.run_cfg.get("num_workers", 4))
        self.output_dir = os.path.join(str(self.run_cfg.get("output_dir", "./output")), job_id)
        if dist.is_main_process():
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
            mu_dtype=self.run_cfg.get("optimizer_mu_dtype"), mesh=self.mesh,
            sharded=[n in self._split_dims for n, _ in model.trainable_parameters()])
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

    def _model_mesh(self, model):
        """The tensor-parallel mesh of ``run.model_shards`` (None for one
        shard): the model's own when ``train.py`` sharded it, else made here
        and the model sharded over it."""
        n_model = dist.model_shards(self.run_cfg)
        mesh = getattr(model, "mesh", None)
        if n_model > 1 and mesh is None:
            mesh = make_mesh(n_model, device=self.device.type)
            model.shard(mesh)
        if (mesh.n_model if mesh is not None else 1) != n_model:
            raise ValueError(f"the model is sharded over {mesh.n_model if mesh else 1} ranks, "
                             f"run.model_shards asks for {n_model}")
        return mesh

    @property
    def _split_dims(self) -> Dict[str, int]:
        """The dim each sharded trainable is cut along, by name."""
        return getattr(self.model, "split_dims", {})

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
                                num_workers=self.num_workers, seed=self.seed,
                                sampler=self._sampler(dataset, shuffle))
                if bool(self.run_cfg.get("prefetch", True)):
                    dl = PrefetchLoader(dl)
                loaders.append(IterLoader(dl))
        if not loaders:
            raise ValueError("no dataset has a train split")
        return loaders, ratios

    def _sampler(self, dataset, shuffle: bool):
        """Over more than one data rank, this data rank's ``DistributedSampler``
        over a map-style split, seeded without the rank offset, so that every
        rank draws one permutation (the ranks of a model group the same
        share); None over one."""
        if dist.get_data_world_size() <= 1:
            return None
        return DistributedSampler(dataset, dist.get_data_world_size(), dist.get_data_rank(),
                                  shuffle=shuffle, seed=self.base_seed)

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
        """One batch: forward, backward (the global token mean's gradient
        across ranks), optimizer.  Returns (loss, the rate of this global
        step) as host floats."""
        arrays, static = self._prepare(samples, rng)
        self.optimizer.zero_grad()
        loss = self._global_mean_backward(*self.model.train_nll(arrays, static))
        self.optimizer.step()
        lr = float(self.schedule(self.global_step // max(self.accum_grad_iters, 1)))
        self.global_step += 1
        loss = float(loss.detach())
        self.losses.append(loss)
        return loss, lr

    def _prepare(self, samples, rng: np.random.Generator):
        """The batch's arrays and static stage: the model's own, or under a
        mesh the model group's first rank's, broadcast to the group (shapes
        and stage as one object, then each tensor)."""
        mesh = self.mesh
        if mesh is None:
            return self.model.prepare_train_arrays(samples, rng)
        meta = None
        if mesh.model_rank == 0:
            arrays, static = self.model.prepare_train_arrays(samples, rng)
            arrays = {k: v.contiguous().clone() for k, v in arrays.items()}
            meta = (static, [(k, tuple(v.shape), v.dtype) for k, v in arrays.items()])
        static, shapes = mesh.broadcast_object(meta)
        if mesh.model_rank != 0:
            arrays = {k: torch.empty(shape, dtype=dtype, device=self.device)
                      for k, shape, dtype in shapes}
        for k, _, _ in shapes:
            mesh.broadcast_(arrays[k])
        return arrays, static

    def _global_mean_backward(self, total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
        """Backpropagate this rank's share of the global token mean, then sum
        the trainables' gradients over the data ranks (under a mesh,
        ``_mesh_grad_sums``); returns the global loss.  Outside a process
        group the sums are this process's own: the batch's mean,
        ``train_loss``'s arithmetic, and its gradient (a tensor the stage
        leaves unused gets zeros, as AdamW reads a missing one)."""
        sums = torch.stack([total.detach().double(), count.double()])
        if self.mesh is None:
            dist.all_sum_([sums])
        else:
            self.mesh.data_sum_([sums])
        n = sums[1].clamp_min(1)
        (total / n.to(total.dtype)).backward()
        grads = []
        for _, p in self.model.trainable_parameters():
            if p.grad is None:  # a stage's unused tensor: zero on every rank
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        if self.mesh is None:
            dist.all_sum_(grads)
        else:
            self._mesh_grad_sums()
        return sums[0].to(total.dtype) / n.to(total.dtype)

    def _mesh_grad_sums(self) -> None:
        """Under a mesh: the replicated trainables' gradients summed over the
        world in one flat buffer, each rank adding its part of a partial one
        (``partition.partial_grad``) and, of any other, the group's first
        rank its value and the others zeros (the model group's sum and the
        data groups' in one collective, the same bits on every rank); a
        shard's gradient is its own, summed over the data group."""
        lead = self.mesh.model_rank == 0
        replicated, shards = [], []
        for name, p in self.model.trainable_parameters():
            if name in self._split_dims:
                shards.append(p.grad)
                continue
            if not (lead or partition.partial_grad(name, p.dim())):
                p.grad.zero_()
            replicated.append(p.grad)
        self.mesh.world_sum_(replicated)
        self.mesh.data_sum_(shards)

    # -- checkpoints -------------------------------------------------------------
    def _to_tree(self, tensors: Dict[str, torch.Tensor]) -> Dict:
        return tree_of(self.model.module, tensors)

    @staticmethod
    def _from_tree(tree) -> Dict[str, torch.Tensor]:
        return {name: t for _, name, t in jax_leaves(tree)}

    def _whole(self, named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Trainable-shaped tensors by name, the shards gathered whole over the
        model group (every rank of the group calls it)."""
        if self.mesh is None:
            return named
        return partition.gather_state(named, self.mesh, self._split_dims)

    def _save_checkpoint(self, epoch, is_best: bool = False) -> str:
        """Every rank calls it; rank 0 builds the state and writes it (the
        trainables and the optimizer's state are the same on every rank of a
        model group; under a mesh every rank gathers the shards whole
        first)."""
        state = None
        if dist.is_main_process() or self.mesh is not None:
            to_tree = lambda named: self._to_tree(self._whole(named))  # noqa: E731
            state = {"model": to_tree(self.model.trainable_state_dict()),
                     "optimizer": self.optimizer.optax_tree(to_tree),
                     "epoch": np.asarray(epoch), "global_step": np.asarray(self.global_step)}
            if not dist.is_main_process():
                state = None
        path = self.ckpt_manager.save("best" if is_best else epoch, state)
        if dist.is_main_process():
            logging.info("Saved checkpoint at epoch %d to %s", epoch, path)
        return path

    def _resume(self, path: str) -> None:
        """Restore a ring checkpoint: an Orbax directory (the JAX runner's
        state), one of the port's earlier ``.pth`` files, or, as the JAX
        runner reads any other file, a parameter tree alone.  The ring holds
        whole tensors; under a mesh each is cut to the rank's piece."""
        trainables = self.model.trainable_state_dict()
        target = trainables
        if self.mesh is not None:  # whole tensors, this rank's pieces taken after
            target = {n: t.detach().clone() for n, t in self._whole(trainables).items()}
        if os.path.isdir(path) or not ckpt_lib.is_port_checkpoint(path):
            state = (ckpt_lib.load_params(path) if os.path.isdir(path)
                     else {"model": ckpt_lib.load_params(path)})
            loaded, _ = ckpt_lib.merge_with_paths(target, state["model"])
            if "optimizer" in state:
                self.optimizer.load_optax_tree(state["optimizer"],
                                               lambda tree: self._cut(self._from_tree(tree)))
        else:
            state = ckpt_lib.load_checkpoint(path)
            loaded, _ = ckpt_lib.merge_into(target, state["model"])
            opt = dict(state["optimizer"])
            for key in ("mu", "nu", "acc"):
                if opt.get(key) is not None:
                    opt[key] = self._cut(opt[key])
            self.optimizer.load_state_dict(opt)
        if self.mesh is not None:
            with torch.no_grad():
                for n, piece in self._cut(target).items():
                    trainables[n].copy_(piece)
        if "epoch" in state:
            self.start_epoch = int(state["epoch"]) + 1
        if "global_step" in state:
            self.global_step = int(state["global_step"])
        logging.info("Resumed from %s (epoch %d, %d tensors)", path, self.start_epoch,
                     len(loaded))

    def _cut(self, named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Whole trainable-shaped tensors cut to this rank's pieces."""
        if self.mesh is None:
            return named
        return partition.cut_state(named, self.mesh, self._split_dims)

    @dist.main_process
    def log_stats(self, stats: Dict, split_name: str = "train") -> None:
        with open(os.path.join(self.output_dir, "log.txt"), "a") as f:
            f.write(json.dumps({f"{split_name}_{k}": v for k, v in stats.items()}) + "\n")

    @dist.main_process
    def log_config(self) -> None:
        with open(os.path.join(self.output_dir, "log.txt"), "a") as f:
            f.write(json.dumps(self.config.to_dict(), default=str) + "\n")

    # -- validation ----------------------------------------------------------------
    @property
    def valid_splits(self):
        return list(self.run_cfg.get("valid_splits", []))

    def eval_loader(self, split_name: str):
        """A loader over the datasets' ``split_name`` split, in order, the last
        short batch kept (this rank's padded share under a world above 1);
        None when no dataset has the split."""
        for splits in self.datasets.values():
            dataset = splits.get(split_name)
            if dataset is not None:
                bs = self.batch_size_train
                if getattr(dataset, "DatasetName", "") == "AnomalyDetection":
                    bs = max(bs // 2, 1)
                return DataLoader(dataset, batch_size=bs, shuffle=False, drop_last=False,
                                  num_workers=self.num_workers, seed=self.seed,
                                  sampler=self._sampler(dataset, False))
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
