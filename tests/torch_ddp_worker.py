"""One rank of the port's data-parallel runner on the CPU (tests/test_torch_ddp.py),
or of its pieces (tests/test_torch_dist.py).

    python tests/torch_ddp_worker.py RANK WORLD STORE WORKDIR LOCAL_BS MAX_TXT WEIGHTS OUT
    python tests/torch_ddp_worker.py pieces RANK WORLD STORE WORKDIR OUT

Joins a gloo group of WORLD ranks through ``common.dist.init_distributed_mode``
(``WORLD_SIZE``/``RANK``/``LOCAL_RANK`` as a launcher sets them, the
rendezvous a ``file://`` store, so no port is taken), builds the tiny fp32
``Myriad`` (no vision expert, LoRA) from the state dict in WEIGHTS, trains
the port's ``RunnerBase`` 2 epochs x 2 iterations at LOCAL_BS rows a rank
over ``DeterministicDataset`` (``shuffle_train: False``) into the shared
``WORKDIR/train/shared``, then resumes ``checkpoint_1`` of that ring into a
fresh runner.  Writes OUT (json): every step's global loss, this rank's
(nll sum, token count) a step, the ring's entries, the resumed epoch and
step and whether the resume restored the trainables bit for bit; and
OUT's stem + ``.pt``: the trained trainables by name.

Imports the port, torch and numpy only (the test process imports JAX).
"""

import json
import os
import sys
import types

import numpy as np

N = 16
QUESTION = "<Img><ImageHere></Img>Is there an anomaly in this image?"
TEXTS = ["No, there exists no anomalies in the image.",
         "Yes, there exists anomalies in the image."]


class DeterministicDataset:
    """Index-keyed samples, the same in every process and run (the dataset of
    tests/multihost_runner_worker.py): even rows answer "No", odd rows the
    shorter "Yes"."""

    def __len__(self):
        return N

    def __getitem__(self, i):
        rng = np.random.default_rng(1000 + i)
        return {"image": rng.normal(size=(28, 28, 3)).astype(np.float32) * 0.5,
                "scene": "bottle", "question": QUESTION, "question2": QUESTION,
                "question3": QUESTION, "text_input": TEXTS[i % 2], "image_id": i}

    def collater(self, samples):
        out = {}
        for k in samples[0]:
            vals = [s[k] for s in samples]
            out[k] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
        return out


def run_config(workdir, out_subdir, local_bs, **extra):
    """The run section both packages train under."""
    return dict(seed=42, max_epoch=2, iters_per_epoch=2, batch_size_train=local_bs,
                num_workers=0, init_lr=1e-3, min_lr=0.0, warmup_steps=0, weight_decay=0.05,
                output_dir=os.path.join(workdir, out_subdir), max_checkpoints=-1,
                prefetch=False, log_freq=50, shuffle_train=False, **extra)


def main(argv):
    rank, world, store, workdir = int(argv[0]), int(argv[1]), argv[2], argv[3]
    local_bs, max_txt, weights, out = int(argv[4]), int(argv[5]), argv[6], argv[7]
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    import torch

    torch.set_num_threads(1)
    from myriad_tpu_torch.common import dist
    from myriad_tpu_torch.models.layers import Policy
    from myriad_tpu_torch.models.myriad import Myriad, MyriadArch
    from myriad_tpu_torch.runners.runner_base import RunnerBase
    from myriad_tpu_torch.tasks import ImageTextPretrainTask

    extra = dict(use_mesh=True, model_shards=1, dist_url=f"file://{store}")
    backend = dist.init_distributed_mode(run_config(workdir, "train", local_bs, **extra), "cpu")
    assert backend == "gloo" and dist.get_world_size() == world and dist.get_rank() == rank
    state = torch.load(weights, weights_only=True)

    def build(out_subdir, **more):
        model = Myriad(MyriadArch.tiny(), policy=Policy.fp32(), device="cpu", use_lora=True,
                       use_ve=False, max_txt_len=max_txt, end_sym="###", training=True)
        model.load_state_dicts(state, None)
        run = run_config(workdir, out_subdir, local_bs, **extra, **more)
        cfg = types.SimpleNamespace(run_cfg=run, to_dict=lambda: {"run": run})
        return RunnerBase(cfg, ImageTextPretrainTask(), model,
                          {"synthetic": {"train": DeterministicDataset()}}, job_id="shared")

    runner = build("train")
    parts = []
    train_nll = runner.model.train_nll

    def recorded(arrays, static):
        total, count = train_nll(arrays, static)
        parts.append((float(total.detach()), int(count)))
        return total, count

    runner.model.train_nll = recorded
    runner.train()
    trained = {n: p.detach().clone() for n, p in runner.model.trainable_parameters()}
    torch.save(trained, os.path.splitext(out)[0] + ".pt")
    ring = sorted(d for d in os.listdir(runner.output_dir) if d.startswith("checkpoint_"))

    resumed = build("resume", resume_ckpt_path=os.path.join(runner.output_dir, "checkpoint_1"))
    restored = all(torch.equal(p.detach(), trained[n])
                   for n, p in resumed.model.trainable_parameters())
    result = {"rank": rank, "losses": runner.losses, "parts": parts, "ring": ring,
              "resumed": [resumed.start_epoch, resumed.global_step, resumed.optimizer.count],
              "restored": restored,
              "log": sorted(os.listdir(runner.output_dir)) if rank == 0 else None}
    dist.barrier("done")
    with open(out, "w") as f:
        json.dump(result, f)


# what each rank of the pieces run logs and saves: rank r's losses and its
# padded share of 5 result rows (rank 1's share repeats row 0)
PIECE_LOSSES = ((1.0, 2.0, 4.0), (8.0, 16.0))
PIECE_SHARES = ((0, 2, 4), (1, 3, 0))


def pieces(argv):
    """``MetricLogger.synchronize_between_processes``, ``all_sum_scalars``,
    ``all_sum_``, ``BaseTask.save_result`` and ``broadcast_object`` on rank
    RANK of WORLD; OUT gets the synchronized meter, the sums, the path
    ``save_result`` returned and the object broadcast."""
    rank, world, store, workdir, out = int(argv[0]), int(argv[1]), argv[2], argv[3], argv[4]
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    import torch

    torch.set_num_threads(1)
    from myriad_tpu_torch.common import dist
    from myriad_tpu_torch.common.logger import MetricLogger
    from myriad_tpu_torch.tasks.base_task import BaseTask

    assert dist.init_distributed_mode({"dist_url": f"file://{store}"}, "cpu") == "gloo"
    logger = MetricLogger()
    for value in PIECE_LOSSES[rank]:
        logger.update(loss=value)
    logger.synchronize_between_processes()
    meter = logger.meters["loss"]
    summed = dist.all_sum_([torch.full((3,), float(rank + 1)), torch.arange(2) + rank])
    rows = [{"image_id": i, "rank": rank} for i in PIECE_SHARES[rank]]
    path = BaseTask.save_result(rows, workdir, "val", remove_duplicate="image_id")
    job = dist.broadcast_object(f"job of rank {rank}")
    with open(out, "w") as f:
        json.dump({"count": meter.count, "total": meter.total, "global_avg": meter.global_avg,
                   "window": list(meter.deque), "scalars": dist.all_sum_scalars(rank, 0.5),
                   "summed": [t.tolist() for t in summed], "path": path,
                   "merged_on_return": os.path.exists(path), "job": job}, f)


if __name__ == "__main__":
    if sys.argv[1] == "pieces":
        pieces(sys.argv[2:])
    else:
        main(sys.argv[1:])
