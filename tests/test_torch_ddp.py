"""The port's data parallelism against the JAX package's DDP contract, on the CPU.

Two gloo ranks of the port's ``RunnerBase`` (``tests/torch_ddp_worker.py``,
subprocesses that import the port and torch only) train the tiny fp32
``Myriad`` (no vision expert, LoRA) at 4 rows a rank, 2 epochs x 2
iterations, ``shuffle_train: False``, over the index-keyed dataset of
``tests/multihost_runner_worker.py``; the JAX ``RunnerBase`` trains the same
weights (carried across with ``convert_from_jax``) in this process at 8 rows
over the same rows.  The ranks' step losses are the JAX runner's within 1e-5
(relative), their trainables within 1e-4 (relative L2 a tensor) and
bit-identical to each other; rank 0 writes one ring in the JAX layout, and
both ranks resume it bit for bit.

Rank 0 holds the even rows, which answer "No, ..." (46 target tokens at
``max_txt_len`` 48), rank 1 the odd rows' 44-token "Yes, ...": the mean of
the two ranks' means is not the global token mean, and the test shows that
it misses the JAX loss by more than 10x the tolerance.
"""

import copy
import json
import os
import subprocess
import sys
import time
import types

import jax
import numpy as np
import pytest
import torch

from myriad_tpu import checkpoint as jax_ckpt
from myriad_tpu.models.layers import Policy as JaxPolicy
from myriad_tpu.models.myriad import MyriadArch as JaxArch
from myriad_tpu.runners.runner_base import RunnerBase as JaxRunner
from myriad_tpu.tasks.image_text_pretrain import ImageTextPretrainTask as JaxTask
from myriad_tpu_torch import checkpoint as ckpt_lib
from myriad_tpu_torch.convert_from_jax import jax_leaves, state_dict_from_jax
from test_torch_myriad import TracedInitMyriad, _perturb
from torch_ddp_worker import DeterministicDataset, run_config
import torch_threads  # noqa: F401  (one torch thread a test process)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_ddp_worker.py")
MAX_TXT = 48
LOCAL_BS = 4
WORLD = 2
RANK_WALL_S = 120  # a rank's own limit: a hung rendezvous fails fast


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _launch(tmp_path, weights):
    store = tmp_path / "store"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for key in ("MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    procs = []
    for rank in range(WORLD):
        out = tmp_path / f"rank{rank}.json"
        procs.append((subprocess.Popen(
            [sys.executable, WORKER, str(rank), str(WORLD), str(store), str(tmp_path / "port"),
             str(LOCAL_BS), str(MAX_TXT), str(weights), str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO),
            out))
    return procs


def _wait(procs, t_start):
    results = []
    try:
        for proc, out in procs:
            left = max(RANK_WALL_S - (time.time() - t_start), 1.0)
            try:
                log, _ = proc.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                pytest.fail(f"a rank ran past {RANK_WALL_S} s")
            assert proc.returncode == 0, f"rank failed:\n{log[-4000:]}"
            with open(out) as f:
                results.append(json.load(f))
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return results


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two port ranks and the JAX runner, run side by side: (the ranks'
    results, their trained trainables, the JAX step losses, the JAX
    trainables by port name, the work directory, the JAX model)."""
    tmp = tmp_path_factory.mktemp("ddp")
    jm = TracedInitMyriad(arch=JaxArch.tiny(), use_ve=False, use_lora=True,
                          policy=JaxPolicy.fp32(), max_txt_len=MAX_TXT, end_sym="###")
    params = _perturb(jax.tree_util.tree_map(np.asarray, jm.params), np.random.default_rng(0))
    jm.trainable, jm.frozen = jax_ckpt.split_by_predicate(params, jm._trainable_predicate())
    weights = tmp / "weights.pt"
    torch.save(state_dict_from_jax(params), weights)
    t_start = time.time()
    procs = _launch(tmp, weights)
    try:
        run = run_config(str(tmp), "jax", WORLD * LOCAL_BS)
        jr = JaxRunner(types.SimpleNamespace(run_cfg=run, to_dict=lambda: {"run": run}),
                       JaxTask(), jm, {"synthetic": {"train": DeterministicDataset()}},
                       job_id="single")
        losses = []
        step = jr.train_iteration

        def recorded(samples, rng):
            loss, lr = step(samples, rng)
            losses.append(float(loss))
            return loss, lr

        jr.train_iteration = recorded
        jr.train()
    finally:
        ranks = _wait(procs, t_start)
    trained = [torch.load(tmp / f"rank{r}.pt", weights_only=True) for r in range(WORLD)]
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jm.trainable))
    return ranks, trained, losses, ref, tmp, jm


def test_two_ranks_train_as_one_process_at_twice_the_batch(runs):
    """Every step's global loss on both ranks (the same value) within 1e-5 of
    the JAX runner's at batch 8; the trained trainables within 1e-4 of its."""
    ranks, trained, losses, ref, _, _ = runs
    assert len(losses) == 4
    assert ranks[0]["losses"] == ranks[1]["losses"]
    for ours, theirs in zip(ranks[0]["losses"], losses):
        assert abs(ours - theirs) <= 1e-5 * abs(theirs), (ranks[0]["losses"], losses)
    assert set(trained[0]) == set(ref)
    worst = {n: _rel(trained[0][n].numpy(), t.numpy()) for n, t in ref.items()}
    assert max(worst.values()) <= 1e-4, sorted(worst.items(), key=lambda kv: -kv[1])[:3]


def test_ranks_trainables_are_bit_identical(runs):
    ranks, trained, _, _, _, _ = runs
    assert [r["rank"] for r in ranks] == [0, 1]
    assert trained[0].keys() == trained[1].keys()
    for n, t in trained[0].items():
        assert torch.equal(t, trained[1][n]), n


def test_ranks_hold_unequal_tokens_and_the_loss_is_the_global_token_mean(runs):
    """Rank 0's 4 rows hold 46 target tokens each, rank 1's 44: the reported
    loss is sum(nll) / sum(count) over both ranks, and the mean of the ranks'
    own means misses the JAX loss by more than 10x the 1e-5 tolerance."""
    ranks, _, losses, _, _, _ = runs
    for step, theirs in enumerate(losses):
        (s0, n0), (s1, n1) = ranks[0]["parts"][step], ranks[1]["parts"][step]
        assert (n0, n1) == (4 * 46, 4 * 44)
        assert ranks[0]["losses"][step] == pytest.approx((s0 + s1) / (n0 + n1), rel=1e-6)
        per_rank_mean = (s0 / n0 + s1 / n1) / 2
        assert abs(per_rank_mean - theirs) > 1e-4 * abs(theirs), (per_rank_mean, theirs)


def test_rank0_writes_one_ring_that_both_ranks_resume(runs):
    """One ring on the shared directory (two epochs, the JAX layout), log.txt
    written once (the config and two epochs' stats), and a resume of
    ``checkpoint_1`` on each rank and by the JAX runner: trainables bit for
    bit, epoch 2, step 4."""
    ranks, trained, _, _, tmp, jm = runs
    shared = tmp / "port" / "train" / "shared"
    assert ranks[0]["log"] == ["checkpoint_0", "checkpoint_1", "log.txt"]
    assert ranks[0]["ring"] == ranks[1]["ring"] == ["checkpoint_0", "checkpoint_1"]
    lines = (shared / "log.txt").read_text().splitlines()
    assert len(lines) == 3 and all("train_loss" in json.loads(x) for x in lines[1:])
    state = ckpt_lib.load_params(str(shared / "checkpoint_1"))
    assert sorted(state) == ["epoch", "global_step", "model", "optimizer"]
    assert (int(state["epoch"]), int(state["global_step"])) == (1, 4)
    saved = {n: t for _, n, t in jax_leaves(state["model"])}
    for n, t in trained[0].items():
        assert torch.equal(torch.as_tensor(saved[n]), t), n
    for r in ranks:
        assert r["restored"] and r["resumed"] == [2, 4, 4]
    # the JAX runner resumes the ring: the ranks' trainables, epoch 2, step 4
    run = run_config(str(tmp), "jax_resume", WORLD * LOCAL_BS,
                     resume_ckpt_path=str(shared / "checkpoint_1"))
    jr = JaxRunner(types.SimpleNamespace(run_cfg=run, to_dict=lambda: {"run": run}),
                   JaxTask(), copy.copy(jm), {})
    assert (jr.start_epoch, jr.global_step) == (2, 4)
    resumed = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jr.model.trainable))
    for n, t in trained[0].items():
        assert torch.equal(resumed[n], t), n
