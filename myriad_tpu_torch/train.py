"""Training over the port (counterpart of the repository's ``train.py``: the same
CLI and config).

    python -m myriad_tpu_torch.train \\
        --cfg-path train_configs/loraadapter_simple_myriad_finetune.yaml \\
        [--options run.max_epoch=1 run.iters_per_epoch=10 ...]

Builds ``common.config.Config`` from the YAML (with the port's copies of the
default YAMLs) and ``--options``, then the task, the datasets, the model and
``RunnerBase``, and trains.  The weights are random, drawn from the model
section's ``seed`` (0 when unset): no pretrained tower is loaded.  It runs on
``run.device``: unset means ``cuda``, ``cpu`` runs on the CPU, and the
shared configs' ``tpu`` (the JAX package's accelerator) is read as ``cuda``,
which the first log line says.  Without a card ``cuda`` raises; nothing
falls back to the CPU.  ``build`` returns the runner before it trains;
``main`` trains it and returns it.
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
    seed = int(config.run_cfg.get("seed", 42)) + dist.get_rank()
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def build(argv=None):
    """The runner of ``argv``, its task, datasets and model built (and resumed
    when ``run.resume_ckpt_path`` names a checkpoint), not yet trained."""
    args = parse_args(argv)
    cfg = Config(args)
    setup_logger()
    device, note = resolve_device(cfg.run_cfg)
    logging.info(note)
    dist.init_distributed_mode(cfg.run_cfg)
    setup_seeds(cfg)
    job_id = datetime.now().strftime("%Y%m%d%H%M%S")
    task = tasks.setup_task(cfg)
    datasets = task.build_datasets(cfg)
    model = task.build_model(cfg, device=device)
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
