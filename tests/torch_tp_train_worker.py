"""One rank of the port's tensor-parallel training on the CPU
(tests/test_torch_tp_train.py).

    python tests/torch_tp_train_worker.py RANK WORLD STORE INPUTS OUT

Joins a gloo group of WORLD ranks through ``common.dist.init_distributed_mode``
with ``model_shards: 2`` (``WORLD_SIZE``/``RANK``/``LOCAL_RANK`` as a launcher
sets them, the rendezvous a ``file://`` store, so no port is taken), builds
the (data, model) mesh (``make_mesh(2)``: data 2 x model 2 at WORLD 4) and
runs what INPUTS (``torch.save``) holds:

* the autograd collectives against their definitions;
* ``steps``: each case's whole state dict (a tiny fp32 Myriad with LoRA,
  float or int8 LLaMA, or a stage-2 MiniGPT-4), its global batch's arrays
  and stage: the model sharded, this data rank's rows through ``train_nll``
  and ``RunnerBase._global_mean_backward``; the global loss and every
  trainable's reduced gradient (a shard's piece as it is); for the float
  case, then one ``AdamW`` step with ``max_grad_norm`` (the global norm and
  the updated trainables gathered whole);
* ``runner``: the whole tiny Myriad trained by ``RunnerBase`` with
  ``model_shards: 2`` (the runner makes the mesh and shards the model) over
  ``DeterministicDataset`` for 1 epoch x 2 iterations, its ring, a resume of
  it and of a one-process ring.

Writes OUT (``torch.save``).  Imports the port, torch and numpy only (the
test process imports JAX).
"""

import datetime
import os
import sys
import time
import types


def autograd_collectives(mesh):
    """Each autograd collective's forward and backward on this rank against
    its definition (n = the model group's size, r = this rank's index)."""
    import torch

    n, r = mesh.n_model, mesh.model_rank
    out = {}
    x = torch.full((2, 3), float(r + 1), requires_grad=True)
    (mesh.copy_to_model(x) * (r + 1)).sum().backward()
    out["copy_to_model"] = bool(torch.all(x.grad == sum(range(1, n + 1))))
    x = torch.full((2, 3), float(r + 1), requires_grad=True)
    y = mesh.reduce_from_model(x)
    (y * 5.0).sum().backward()
    out["reduce_from_model"] = bool(torch.all(y == n * (n + 1) / 2) and torch.all(x.grad == 5.0))
    x = torch.full((2, 3), float(r), requires_grad=True)
    y = mesh.gather_from_model(x)
    v = torch.arange(2 * 3 * n, dtype=torch.float32).reshape(2, 3 * n)
    (y * v).sum().backward()
    want = torch.arange(n, dtype=torch.float32).repeat_interleave(3).expand(2, -1)
    out["gather_from_model"] = bool(torch.equal(y, want)
                                    and torch.equal(x.grad, v[:, 3 * r:3 * r + 3]))
    x = torch.full((2, 3), float(r + 7), requires_grad=(r == 0))
    y = mesh.broadcast_from_lead(x)
    if r == 0:
        (y * 3.0).sum().backward()
    out["broadcast_from_lead"] = bool(torch.all(y == 7.0)
                                      and (r != 0 or torch.all(x.grad == 3.0)))
    return out


def _runner(model, workdir, sub, **run):
    from myriad_tpu_torch.runners.runner_base import RunnerBase
    from myriad_tpu_torch.tasks import ImageTextPretrainTask
    from torch_ddp_worker import DeterministicDataset, run_config

    local_bs = run.pop("local_bs", 4)
    run = dict(run_config(workdir, sub, local_bs, model_shards=2), **run)
    cfg = types.SimpleNamespace(run_cfg=run, to_dict=lambda: {"run": run})
    return RunnerBase(cfg, ImageTextPretrainTask(), model,
                      {"synthetic": {"train": DeterministicDataset()}}, job_id="shared")


def _build(case):
    from myriad_tpu_torch.common.config import ConfigDict
    from myriad_tpu_torch.models.layers import Policy
    from myriad_tpu_torch.models.llama import LlamaConfig
    from myriad_tpu_torch.models.mini_gpt4 import MiniGPT4
    from myriad_tpu_torch.models.myriad import Myriad, MyriadArch

    if case["model"] == "mini_gpt4":
        model = MiniGPT4.from_config(ConfigDict(case["cfg"]), device="cpu", training=True)
        model.load_state_dicts(case["state"])
        return model
    arch = MyriadArch.tiny(llama=LlamaConfig.tiny(weight_dtype=case.get("weights", "bf16")))
    model = Myriad(arch, policy=Policy.fp32(), device="cpu", use_lora=True, use_ve=False,
                   max_txt_len=case["max_txt"], end_sym="###", training=True)
    model.load_state_dicts(case["state"], None)
    return model


def train_steps(inputs, mesh, workdir):
    from myriad_tpu_torch.common.optim import AdamW

    out = {}
    for name, case in inputs["steps"].items():
        model = _build(case).shard(mesh)
        d, per = mesh.data_rank, case["rows"] // mesh.n_data
        arrays = {k: (v[d * per:(d + 1) * per] if k not in ("before", "after") else v)
                  for k, v in case["arrays"].items()}
        runner = _runner(model, workdir, f"step_{name}")
        mesh.reset()
        total, count = model.train_nll(arrays, case["static"])
        loss = runner._global_mean_backward(total, count)
        res = {"loss": float(loss), "calls": dict(mesh.calls),
               "grads": {n: p.grad.detach().clone() for n, p in model.trainable_parameters()},
               "split_dims": dict(model.split_dims),
               "shapes": {n: tuple(p.shape) for n, p in model.trainable_parameters()}}
        if "clip" in case:
            named = model.trainable_parameters()
            opt = AdamW(named, lambda step: case["lr"], weight_decay=0.05,
                        max_grad_norm=case["clip"], mesh=mesh,
                        sharded=[n in model.split_dims for n, _ in named])
            res["norm"] = float(opt._global_norm([p.grad for _, p in named]))
            opt.step()
            res["stepped"] = runner._whole({n: p.detach() for n, p in named})
        out[name] = res
    return out


def train_runner(inputs, workdir):
    spec = inputs["runner"]
    model = _build(dict(spec, model="myriad"))
    runner = _runner(model, workdir, "train", max_epoch=1, iters_per_epoch=2,
                     max_grad_norm=spec["clip"], local_bs=spec["local_bs"])
    mesh = runner.mesh
    runner.train()
    named = model.trainable_parameters()
    pieces = {n: p.detach().clone() for n, p in named}
    whole = runner._whole(pieces)
    ring = os.path.join(runner.output_dir, "checkpoint_0")
    res = {"losses": list(runner.losses), "pieces": pieces, "whole": whole,
           "model_rank": mesh.model_rank, "data_rank": mesh.data_rank, "n_data": mesh.n_data,
           "ring": ring, "split_dims": dict(model.split_dims),
           "mu": dict(zip(runner.optimizer.names, runner.optimizer.mu)),
           "nu": dict(zip(runner.optimizer.names, runner.optimizer.nu))}
    # the ring resumed on this rank, re-sharded, into a fresh runner
    back = _runner(_build(dict(spec, model="myriad")), workdir, "resume",
                   resume_ckpt_path=ring, max_grad_norm=spec["clip"])
    res["resumed"] = {n: p.detach().clone() for n, p in back.model.trainable_parameters()}
    res["resumed_mu"] = dict(zip(back.optimizer.names, back.optimizer.mu))
    res["resumed_nu"] = dict(zip(back.optimizer.names, back.optimizer.nu))
    res["resumed_at"] = [back.start_epoch, back.global_step, back.optimizer.count]
    # a ring written by one process (the test's, beside the ranks), cut to
    # this rank's pieces
    t_end = time.time() + 100
    while not os.path.exists(spec["one_ready"]) and time.time() < t_end:
        time.sleep(0.05)
    one = _runner(_build(dict(spec, model="myriad")), workdir, "resume_one",
                  resume_ckpt_path=spec["one_ring"], max_grad_norm=spec["clip"])
    res["from_one"] = {n: p.detach().clone() for n, p in one.model.trainable_parameters()}
    res["from_one_mu"] = dict(zip(one.optimizer.names, one.optimizer.mu))
    return res


def main(argv):
    rank, world, store, inputs_path, out_path = (int(argv[0]), int(argv[1]), argv[2], argv[3],
                                                 argv[4])
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    import torch

    torch.set_num_threads(1)
    from myriad_tpu_torch.common import dist
    from myriad_tpu_torch.parallel.mesh import make_mesh

    backend = dist.init_distributed_mode({"model_shards": 2, "dist_url": f"file://{store}"},
                                         "cpu")
    try:
        dist.init_distributed_mode({"model_shards": 3}, "cpu")
        refused = ""
    except ValueError as e:
        refused = str(e)
    mesh = make_mesh(2, device="cpu", timeout=datetime.timedelta(seconds=60))
    inputs = torch.load(inputs_path, weights_only=False)
    workdir = inputs["workdir"]
    out = {"rank": rank, "backend": backend, "refused": refused,
           "model_rank": mesh.model_rank, "data_rank": mesh.data_rank,
           "data_axis": [dist.get_data_rank(), dist.get_data_world_size()],
           "collectives": autograd_collectives(mesh),
           "steps": train_steps(inputs, mesh, workdir),
           "runner": train_runner(inputs, workdir)}
    dist.barrier("done")
    torch.save(out, out_path)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main(sys.argv[1:]))
