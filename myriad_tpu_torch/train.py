"""Training over the port (counterpart of the repository's ``train.py``: the same
CLI and config).

    python -m myriad_tpu_torch.train \\
        --cfg-path train_configs/loraadapter_simple_myriad_finetune.yaml \\
        [--options run.max_epoch=1 run.iters_per_epoch=10 ...]

Data parallel over N cards of a host, one rank a card:

    torchrun --nproc_per_node N -m myriad_tpu_torch.train --cfg-path ...

With ``run.model_shards: n`` (n dividing N) the LLaMA is sharded over model
groups of n consecutive ranks (tensor parallelism, the JAX runner's
``model`` mesh axis) and the N / n data groups split the batch.

Builds ``common.config.Config`` from the YAML (with the port's copies of the
default YAMLs) and ``--options``, then the task, the datasets, the model and
``RunnerBase``, and trains.  The model is ``model.arch``'s (``myriad`` or
``mini_gpt4``); its weights are random, drawn from the model section's
``seed`` (0 when unset), and then its ``weights:`` towers and ``ckpt:``
checkpoint load over them.  It runs on
``run.device``: unset means ``cuda``, ``cpu`` runs on the CPU, and the
shared configs' ``tpu`` (the JAX package's accelerator) is read as ``cuda``,
which the first log line says.  Without a card ``cuda`` raises; nothing
falls back to the CPU.  Under a launcher (``WORLD_SIZE`` above 1) the
process joins the group before anything touches the card
(``common.dist.init_distributed_mode``) and runs on ``cuda:LOCAL_RANK``
(modulo the host's cards); ``batch_size_train`` is each data group's
batch.  Under ``model_shards`` > 1 the mesh is built
(``parallel.mesh.make_mesh``) before the seeds, which follow the data rank,
and the model is sharded over it (``shard``) before the runner.
``build`` returns the runner before it trains; ``main`` trains it and
returns it.
"""

from __future__ import annotations

import argparse
import logging
import random
from datetime import datetime

import numpy as np
import torch

from myriad_tpu_torch import tasks
from myriad_tpu_torch.common import dist
from myriad_tpu_torch.common.config import Config
from myriad_tpu_torch.common.logger import setup_logger
from myriad_tpu_torch.parallel.mesh import make_mesh
from myriad_tpu_torch.runners import RUNNERS


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Training (PyTorch port)")
    parser.add_argument("--cfg-path", required=True, help="path to configuration file.")
    parser.add_argument("--options", nargs="+",
                        help="override some settings in the used config; key-value pairs "
                             "in xxx=yyy format are merged into the config file.")
    return parser.parse_args(argv)


def resolve_device(run_cfg):
    """(device, a note for the log) from ``run.device``."""
    name = run_cfg.get("device")
    if name in (None, "", "cuda"):
        note = f"run.device={name!r}: training on cuda"
        name = "cuda"
    elif name == "tpu":
        note = "run.device='tpu' names the JAX package's accelerator: the port reads it as cuda"
        name = "cuda"
    elif name == "cpu":
        note = "run.device='cpu': training on the CPU"
    else:
        raise ValueError(f"run.device={name!r}: the port trains on cuda (or tpu, read as "
                         "cuda) or cpu")
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"train runs on the card ({note}), and torch sees no CUDA device; "
                           "set run.device: cpu to run it on the CPU")
    return device, note


def setup_seeds(config) -> None:
    seed = int(config.run_cfg.get("seed", 42)) + dist.get_data_rank()
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def build(argv=None):
    """The runner of ``argv``, its task, datasets and model built (and resumed
    when ``run.resume_ckpt_path`` names a checkpoint), not yet trained."""
    args = parse_args(argv)
    cfg = Config(args)
    device, note = resolve_device(cfg.run_cfg)
    backend = dist.init_distributed_mode(cfg.run_cfg, device.type)
    device = dist.device_of(device.type)
    setup_logger()
    logging.info(note)
    n_model = dist.model_shards(cfg.run_cfg)
    mesh = make_mesh(n_model, device=device.type) if n_model > 1 else None
    if backend:
        logging.info("data parallel: rank %d of %d on %s over %s", dist.get_rank(),
                     dist.get_world_size(), device, backend)
    if mesh is not None:
        logging.info("tensor parallel: model rank %d of %d, data rank %d of %d",
                     mesh.model_rank, mesh.n_model, mesh.data_rank, mesh.n_data)
    setup_seeds(cfg)
    # one output directory for the job: rank 0's clock names it on every rank
    job_id = dist.broadcast_object(datetime.now().strftime("%Y%m%d%H%M%S"))
    task = tasks.setup_task(cfg)
    datasets = task.build_datasets(cfg)
    model = task.build_model(cfg, device=device)
    if mesh is not None:
        model.shard(mesh)
    runner_name = cfg.run_cfg.get("runner", "runner_base")
    if runner_name not in RUNNERS:
        raise KeyError(f"Unknown runner '{runner_name}'. Registered: [{', '.join(RUNNERS)}]")
    return RUNNERS[runner_name](cfg=cfg, task=task, model=model, datasets=datasets,
                                job_id=job_id)


def main(argv=None):
    runner = build(argv)
    runner.train()
    return runner


if __name__ == "__main__":
    main()
