"""The pieces of the port's data parallelism against the JAX package's, on the CPU.

* ``DistributedSampler`` equal to the JAX one over sizes, replica counts,
  epochs and ``shuffle``; ``DataLoader(sampler=)`` batches and ``set_epoch``
  equal to the JAX loader's;
* over a two-rank gloo group (``tests/torch_ddp_worker.py pieces``, two
  subprocesses through a ``file://`` store): ``synchronize_between_processes``
  (the JAX logger's sums), ``all_sum_scalars``, ``all_sum_``,
  ``broadcast_object`` and ``save_result`` (the merged file equal to the JAX task's merge of the same
  rank files, ``remove_duplicate`` applied);
* the tar stream draws the same batches on every rank, as the JAX reader
  does (its seed has no rank offset);
* the transport rule, the launcher's environment and no fallback after a
  failed join;
* ``common/card_lock.py``: the cases of tests/test_tpu_lock.py (acquire and
  release, busy, stale pid, expired deadline, garbage, inherited token,
  release on error, required raises), a race of concurrent acquirers with
  exactly one winner, and the warning about a live holder past its deadline;
  ``python -m myriad_tpu_torch.evaluate`` holds the lock on the card and
  never on the CPU.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from myriad_tpu.common import dist as jax_dist
from myriad_tpu.datasets import builders as jbuilders
from myriad_tpu.datasets import loaders as jloaders
from myriad_tpu.datasets.loaders import IterableBatcher as JaxBatcher
from myriad_tpu.tasks.base_task import BaseTask as JaxTask
from myriad_tpu_torch import evaluate
from myriad_tpu_torch.common import card_lock, dist
from myriad_tpu_torch.common.config import ConfigDict
from myriad_tpu_torch.datasets import builders as tbuilders
from myriad_tpu_torch.datasets import loaders as tloaders
from myriad_tpu_torch.runners import runner_base
from test_torch_captions import _write_shard
from torch_ddp_worker import PIECE_LOSSES, PIECE_SHARES
import torch_threads  # noqa: F401  (one torch thread a test process)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_ddp_worker.py")
LOCK_SOURCE = os.path.join(REPO, "myriad_tpu_torch", "common", "card_lock.py")


# -- samplers and loaders ---------------------------------------------------------
@pytest.mark.parametrize("size", [1, 5, 16, 17])
@pytest.mark.parametrize("replicas", [1, 2, 3, 4])
def test_distributed_sampler_equals_the_jax_one(size, replicas):
    """Every rank's indices at epochs 0, 1 and 7, shuffled and in order; the
    ranks' shares cover the padded permutation."""
    data = list(range(size))
    for shuffle in (True, False):
        for epoch in (0, 1, 7):
            shares = []
            for rank in range(replicas):
                ours = tloaders.DistributedSampler(data, replicas, rank, shuffle=shuffle,
                                                   seed=42)
                ref = jloaders.DistributedSampler(data, replicas, rank, shuffle=shuffle,
                                                  seed=42)
                ours.set_epoch(epoch)
                ref.set_epoch(epoch)
                assert list(ours) == list(ref) and len(ours) == len(ref)
                shares.append(list(ours))
            assert sorted(set(sum(shares, []))) == data


class _Rows:
    """Rows that carry their index."""

    def __len__(self):
        return 11

    def __getitem__(self, i):
        return {"image_id": i, "x": np.full((2,), i, np.float32)}

    def collater(self, samples):
        return {"image_id": [s["image_id"] for s in samples],
                "x": np.stack([s["x"] for s in samples])}


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_with_a_sampler_equals_the_jax_loader(drop_last):
    """``DataLoader(sampler=)`` over rank 1 of 3 (shuffled) across epochs set
    by ``IterLoader`` and by hand: the same batches as the JAX loader's."""
    def loaders(mod):
        sampler = mod.DistributedSampler(_Rows(), 3, 1, shuffle=True, seed=7)
        return mod.DataLoader(_Rows(), batch_size=2, shuffle=True, drop_last=drop_last,
                              seed=8, sampler=sampler)

    ours, ref = loaders(tloaders), loaders(jloaders)
    assert len(ours) == len(ref)
    for epoch in (0, 3):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert [b["image_id"] for b in ours] == [b["image_id"] for b in ref]
    ours.set_epoch(0)
    ref.set_epoch(0)
    it_ours, it_ref = tloaders.IterLoader(ours), jloaders.IterLoader(ref)
    for _ in range(3 * len(ref) + 1):  # through the epochs IterLoader starts
        assert next(it_ours)["image_id"] == next(it_ref)["image_id"]


# -- a two-rank gloo group -----------------------------------------------------------
@pytest.fixture(scope="module")
def pieces(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pieces")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, WORKER, "pieces", str(r), "2", str(tmp / "store"),
                               str(tmp / "results"), str(tmp / f"rank{r}.json")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=REPO) for r in range(2)]
    t_end = time.time() + 120
    outs = []
    try:
        for proc in procs:
            try:
                log, _ = proc.communicate(timeout=max(t_end - time.time(), 1.0))
            except subprocess.TimeoutExpired:
                pytest.fail("a rank ran past 120 s")
            assert proc.returncode == 0, log[-4000:]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for r in range(2):
        with open(tmp / f"rank{r}.json") as f:
            outs.append(json.load(f))
    return outs, tmp


def test_metric_logger_sums_over_the_ranks(pieces):
    """Each meter's count and total summed over the ranks, as the JAX
    ``SmoothedValue`` sums them; the window stays the rank's own."""
    outs, _ = pieces
    values = [v for losses in PIECE_LOSSES for v in losses]
    for rank, out in enumerate(outs):
        assert (out["count"], out["total"]) == (len(values), sum(values))
        assert out["global_avg"] == sum(values) / len(values)
        assert out["window"] == list(PIECE_LOSSES[rank])
        assert out["scalars"] == [1.0, 1.0]  # (0 + 1, 0.5 + 0.5)
        assert out["summed"] == [[3.0, 3.0, 3.0], [1, 3]]
        assert out["job"] == "job of rank 0"  # train.build names one output directory


def test_save_result_merges_as_the_jax_task(pieces, tmp_path, monkeypatch):
    """The merged file (rank 0's rows, then rank 1's, the repeated row 0
    dropped by ``remove_duplicate``) equals the JAX task's merge of the same
    per-rank files, and every rank returned its path after it was written."""
    outs, tmp = pieces
    path = tmp / "results" / "val.json"
    assert all(o["path"] == str(path) and o["merged_on_return"] for o in outs)
    merged = json.loads(path.read_text())
    assert [r["image_id"] for r in merged] == [0, 2, 4, 1, 3]
    for rank in (1, 0):  # the JAX task's rank 1, then its rank 0, which merges
        monkeypatch.setattr(jax_dist, "get_rank", lambda r=rank: r)
        monkeypatch.setattr(jax_dist, "is_main_process", lambda r=rank: r == 0)
        monkeypatch.setattr(jax_dist, "get_world_size", lambda: 2)
        monkeypatch.setattr(jax_dist, "barrier", lambda name="": None)
        rows = [{"image_id": i, "rank": rank} for i in PIECE_SHARES[rank]]
        ref = JaxTask.save_result(rows, str(tmp_path), "val", remove_duplicate="image_id")
    assert json.loads(open(ref).read()) == merged
    for rank in (0, 1):
        assert ((tmp / "results" / f"val_rank{rank}.json").read_text()
                == (tmp_path / f"val_rank{rank}.json").read_text())


def test_tar_stream_draws_the_same_batches_on_every_rank(tmp_path, monkeypatch):
    """The laion builder's stream under the runner as rank 0 and as rank 1 of
    2: the same batches, equal to the JAX reader's (seeded without a rank
    offset), while the runners' own seeds differ by the rank."""
    _write_shard(str(tmp_path / "00000.tar"), 6, "a gadget", seed=1)
    _write_shard(str(tmp_path / "00001.tar"), 5, "a bridge", seed=2, start=100)
    cfg = {"build_info": {"storage": str(tmp_path / "*.tar")},
           "vis_processor": {"train": {"name": "blip2_image_train", "image_size": 28}},
           "text_processor": {"train": {"name": "blip_caption"}}}
    run = {"seed": 42, "batch_size_train": 3, "output_dir": str(tmp_path / "out"),
           "num_workers": 0}
    draws = []
    for rank in (0, 1):
        monkeypatch.setattr(dist, "get_rank", lambda r=rank: r)
        monkeypatch.setattr(dist, "get_world_size", lambda: 2)
        datasets = {"laion": tbuilders.get_builder_class("laion")(ConfigDict(cfg))
                    .build_datasets()}
        model = type("M", (), {"device": torch.device("cpu"),
                               "trainable_parameters": lambda self: []})()
        runner = runner_base.RunnerBase(
            type("C", (), {"run_cfg": ConfigDict(run), "to_dict": lambda self: run})(),
            None, model, datasets, job_id=f"rank{rank}")
        assert runner.seed == 42 + rank and runner.base_seed == 42
        loader = runner.train_loader
        draws.append([next(loader) for _ in range(5)])
    jds = jbuilders.registry.get_builder_class("laion")(ConfigDict(cfg)).build_datasets()
    ref = JaxBatcher(jds["train"], 3)
    for b0, b1 in zip(*draws):
        rb = next(ref)
        assert b0["text_input"] == b1["text_input"] == rb["text_input"]
        np.testing.assert_array_equal(b0["image"], b1["image"])
        np.testing.assert_array_equal(b0["image"], rb["image"])


# -- joining --------------------------------------------------------------------------
@pytest.mark.parametrize("device,local_world,cards,backend", [
    ("cpu", 2, 0, "gloo"), ("cpu", 2, 8, "gloo"), ("cuda", 1, 1, "nccl"),
    ("cuda", 4, 4, "nccl"), ("cuda", 2, 1, "gloo"), ("cuda", 8, 4, "gloo")])
def test_transport_rule(device, local_world, cards, backend):
    """gloo for CPU ranks, NCCL when every rank has a card of its own, gloo on
    CUDA tensors when the ranks outnumber the cards."""
    assert dist.transport(device, local_world, cards) == backend


def test_join_is_the_launchers_and_never_falls_back(monkeypatch):
    """Without a launcher (or at ``WORLD_SIZE`` 1) the join is a no-op and the
    device is the config's; under one it joins once, with the rule's backend
    and the config's rendezvous, and a failed join raises as it is."""
    calls = []
    monkeypatch.setattr(dist.tdist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)) or (_ for _ in ()).throw(
                            RuntimeError("rendezvous failed")))
    for world in (None, "1"):
        if world is None:
            monkeypatch.delenv("WORLD_SIZE", raising=False)
        else:
            monkeypatch.setenv("WORLD_SIZE", world)
        assert dist.init_distributed_mode({"world_size": 4, "use_mesh": True}, "cpu") is None
        assert dist.device_of("cuda") == torch.device("cuda") and not calls
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="rendezvous failed"):
        dist.init_distributed_mode({"dist_url": "file:///nowhere"}, "cpu")
    assert len(calls) == 1
    (backend,), kwargs = calls[0]
    assert backend == "gloo" and kwargs["init_method"] == "file:///nowhere"
    assert (kwargs["world_size"], kwargs["rank"]) == (2, 1)
    assert dist.get_world_size() == 1 and dist.get_rank() == 0
    assert dist.device_of("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="2 ranks not divisible by model axis 3"):
        dist.init_distributed_mode({"model_shards": 3}, "cpu")
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(ValueError, match="1 ranks not divisible by model axis 2"):
        dist.init_distributed_mode({"model_shards": 2}, "cpu")


# -- the card lock --------------------------------------------------------------------
DEAD_PID = 2 ** 22 + 12345


@pytest.fixture
def lockfile(tmp_path, monkeypatch):
    path = str(tmp_path / "card.lock")
    monkeypatch.setenv(card_lock.ENV_PATH, path)
    monkeypatch.delenv(card_lock.ENV_TOKEN, raising=False)
    return path


def _write(path, **rec):
    with open(path, "w") as f:
        json.dump(dict({"t0": 0, "token": "not-ours"}, **rec), f)


def test_card_lock_acquire_release_roundtrip(lockfile):
    assert card_lock.acquire("t1") is True
    rec = json.load(open(lockfile))
    assert rec["pid"] == os.getpid() and rec["tag"] == "t1"
    assert card_lock.holder() is not None
    card_lock.release()
    assert not os.path.exists(lockfile) and card_lock.holder() is None


def test_card_lock_busy_blocks_a_second_acquirer(lockfile):
    _write(lockfile, pid=os.getpid(), tag="other", deadline=1e18)
    t0 = time.time()
    assert card_lock.acquire("t2", wait_s=0.3, poll_s=0.1) is False
    assert time.time() - t0 >= 0.3
    assert json.load(open(lockfile))["token"] == "not-ours"


@pytest.mark.parametrize("case", ["stale_pid", "expired_dead", "garbage", "expired_alive"])
def test_card_lock_reclaims_a_stale_record(lockfile, case, capsys):
    """A dead pid, a passed deadline or an unreadable file is reclaimed; a
    live holder past its deadline is reported (pid and tag) before it is."""
    if case == "garbage":
        open(lockfile, "w").write("not json{")
    else:
        _write(lockfile, pid=os.getpid() if case == "expired_alive" else DEAD_PID,
               tag="overstayer", deadline=1.0 if case.startswith("expired") else 1e18)
    assert card_lock.acquire("t3", wait_s=0.0) is True
    assert json.load(open(lockfile))["tag"] == "t3"
    card_lock.release()
    err = capsys.readouterr().err
    warned = f"pid {os.getpid()} (overstayer) holds the card past its deadline" in err
    assert warned == (case == "expired_alive"), err


def _lock_python(code):
    """A Python program that loads card_lock.py alone (no torch) as ``m``."""
    return ("import importlib.util, os, sys, time\n"
            f"spec = importlib.util.spec_from_file_location('card_lock', {LOCK_SOURCE!r})\n"
            "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n" + code)


def test_card_lock_subprocess_inherits_the_hold(lockfile):
    code = _lock_python("sys.exit(0 if m.acquire('child', wait_s=0.0) else 1)")
    assert card_lock.acquire("parent") is True
    try:
        env = dict(os.environ)
        assert subprocess.run([sys.executable, "-c", code], env=env).returncode == 0
        env.pop(card_lock.ENV_TOKEN)
        assert subprocess.run([sys.executable, "-c", code], env=env,
                              stderr=subprocess.DEVNULL).returncode == 1
        assert json.load(open(lockfile))["pid"] == os.getpid()
    finally:
        card_lock.release()
    assert not os.path.exists(lockfile)


def test_card_lock_releases_on_error(lockfile):
    with pytest.raises(RuntimeError, match="boom"):
        with card_lock.card_lock("cm"):
            assert card_lock.holder()["tag"] == "cm"
            raise RuntimeError("boom")
    assert card_lock.holder() is None and not os.path.exists(lockfile)


def test_card_lock_required_raises_when_busy(lockfile):
    _write(lockfile, pid=os.getpid(), tag="other", deadline=1e18)
    with pytest.raises(RuntimeError, match="card lock"):
        with card_lock.card_lock("cm2", wait_s=0.0, required=True):
            pass  # pragma: no cover
    with card_lock.card_lock("cm3", wait_s=0.0) as got:
        assert got is False
    assert json.load(open(lockfile))["token"] == "not-ours"


RACERS = 8


@pytest.mark.parametrize("start", ["free", "stale"])
def test_card_lock_race_has_exactly_one_winner(lockfile, tmp_path, start):
    """Eight processes acquire at one instant (a free lock, or a dead holder's
    record that each of them may reclaim): exactly one wins, and it holds
    the lockfile until it releases."""
    if start == "stale":
        _write(lockfile, pid=DEAD_PID, tag="dead", deadline=1e18)
    go, done = tmp_path / "go", tmp_path / "done"
    code = _lock_python(
        "open(sys.argv[3], 'w').close()\n"
        "while not os.path.exists(sys.argv[1]): time.sleep(0.0005)\n"
        "got = m.acquire('racer', wait_s=0.0)\n"
        "print('WON' if got else 'LOST', os.getpid(), flush=True)\n"
        "while got and not os.path.exists(sys.argv[2]): time.sleep(0.01)\n"
        "got and m.release()\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(go), str(done),
                               str(tmp_path / f"ready{i}")], stdout=subprocess.PIPE,
                              stderr=subprocess.DEVNULL, text=True) for i in range(RACERS)]
    try:
        t_end = time.time() + 60
        while sum(os.path.exists(tmp_path / f"ready{i}") for i in range(RACERS)) < RACERS:
            assert time.time() < t_end, "the racers did not start"
            time.sleep(0.01)
        go.touch()
        lines = []
        for proc in procs:  # the losers exit at once
            line = proc.stdout.readline().split()
            lines.append(line)
        winners = [pid for word, pid in lines if word == "WON"]
        assert len(winners) == 1, lines
        assert str(json.load(open(lockfile))["pid"]) == winners[0]
    finally:
        done.touch()
        for proc in procs:
            proc.communicate(timeout=60)
    assert not os.path.exists(lockfile)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_evaluate_holds_the_card_lock_on_the_card_only(lockfile, tmp_path, monkeypatch,
                                                       device):
    """``evaluate.main`` builds and runs under the lock when ``run.device`` is
    the card, without it on the CPU; the lock is released afterwards."""
    path = tmp_path / "eval.yaml"
    path.write_text(textwrap.dedent(f"""
        model:
          arch: myriad
          arch_preset: tiny
        run:
          device: {device}
    """))
    seen = []
    monkeypatch.setattr(evaluate, "build_model", lambda args, cfg: seen.append(
        ("build", card_lock.holder())) or "model")
    monkeypatch.setattr(evaluate, "run", lambda args, cfg, model: seen.append(
        ("run", card_lock.holder())) or {"rows": []})
    assert evaluate.main(["--cfg-path", str(path)]) == {"rows": []}
    for step, rec in seen:
        if device == "cpu":
            assert rec is None, step
        else:
            assert rec["tag"] == "eval_aqa" and rec["pid"] == os.getpid(), step
    assert [s for s, _ in seen] == ["build", "run"]
    assert not os.path.exists(lockfile)
