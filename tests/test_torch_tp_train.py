"""The port's tensor-parallel training (``run.model_shards: 2``) against the JAX
package's ``model`` mesh axis, on the CPU.

Four gloo ranks of ``tests/torch_tp_train_worker.py`` (port and torch only,
a ``file://`` store, one torch thread each, started once for the module)
form a data 2 x model 2 mesh: model groups of two consecutive ranks hold
the LLaMA's shards, the two data groups split the batch.  The JAX side is
the JAX runner's placement, rebuilt here: the trainable and frozen trees
put with ``tree_shardings(myriad_rules())`` on ``make_mesh(n_model=2)``
(data 4 x model 2 over the suite's 8 CPU devices), the batch over the data
axis, one jitted ``value_and_grad`` of ``pure_loss`` under GSPMD.

Gates:
* each autograd collective's backward against its definition;
* the step of a tiny fp32 Myriad with LoRA (float and int8 LLaMA, W8A8 on
  the CPU) and of a stage-2 MiniGPT-4: the global loss within 1e-5
  relative of the JAX step's, every trainable's reduced gradient within
  1e-4 relative L2 (a rank's ``lora_b`` against the JAX gradient's slice on
  its model index; ``lora_a``, whose parts the ranks sum, against the whole
  one), replicated gradients bit-identical on every rank;
* ``clip_by_global_norm`` over the shards: the global norm within 1e-5 of
  optax's and one clipped AdamW step within 1e-5 of ``make_optimizer``'s;
* the runner (two steps, clipped): losses within 1e-5 and trainables within
  1e-4 of the port's one-process runner at the same global batch; the ring
  whole (every leaf's shape the one-process ring's), resumed re-sharded by
  every rank and whole by one process, bit for bit, and the one-process
  ring resumed by the ranks;
* the refusals: a world that the model axis does not divide, a model axis
  in a world of one, int4 weights under autograd.
"""

import dataclasses
import os
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from myriad_tpu import checkpoint as jax_ckpt
from myriad_tpu.common import optim as jax_optim
from myriad_tpu.common.config import ConfigDict as JaxConfigDict
from myriad_tpu.models.layers import Policy as JaxPolicy
from myriad_tpu.models.myriad import MyriadArch as JaxArch
from myriad_tpu.ops import quant as jax_quant
from myriad_tpu.parallel import mesh as jax_mesh
from myriad_tpu.parallel import partition as jax_partition
from myriad_tpu_torch import checkpoint as ckpt_lib
from myriad_tpu_torch.common import dist
from myriad_tpu_torch.common.config import ConfigDict
from myriad_tpu_torch.convert_from_jax import jax_leaves, state_dict_from_jax
from myriad_tpu_torch.models.layers import Policy
from myriad_tpu_torch.models.mini_gpt4 import MiniGPT4
from myriad_tpu_torch.models.myriad import Myriad, MyriadArch
from myriad_tpu_torch.ops import quant
from myriad_tpu_torch.parallel.mesh import Mesh, make_mesh
from myriad_tpu_torch.runners.runner_base import RunnerBase as PortRunner
from myriad_tpu_torch.tasks import ImageTextPretrainTask
from test_torch_mini_gpt4 import TracedInitMiniGPT4
from test_torch_myriad import TracedInitMyriad, _jax_variant, _perturb
from torch_ddp_worker import DeterministicDataset, run_config
import torch_threads  # noqa: F401  (one torch thread a test process)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_tp_train_worker.py")
WORLD, N_MODEL = 4, 2
RANK_WALL_S = 150  # a rank's own limit: a hung rendezvous fails fast
QUESTION = "<Img><ImageHere></Img>Any defect?"
MAX_TXT = 16  # the steps' targets
RUNNER_TXT = 48  # the runner's (DeterministicDataset's answers: 46 and 44 tokens)
ROWS = 4  # the steps' global batch: 2 rows a data group
LOCAL_BS = 4  # the runner's rows a data group
CLIP = 1e-3  # well under every gradient's norm here: every step clips
LR = 1e-3
MINIGPT4_CFG = {"arch": "mini_gpt4", "arch_preset": "tiny", "image_size": 28,
                "vit_precision": "fp32", "max_txt_len": 20, "end_sym": "###",
                "prompt_path": os.path.join(REPO, "prompts", "alignment.txt"),
                "prompt_template": "###Human: {} ###Assistant: ", "llama_model": "",
                "seed": 3}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _samples(n):
    rng = np.random.default_rng(5)
    return {"image": rng.normal(size=(n, 28, 28, 3)).astype(np.float32),
            "scene": ["bottle"] * n, "question": [QUESTION] * n,
            "question2": [QUESTION] * n, "question3": [QUESTION] * n,
            "text_input": ["No, there exists no anomalies in the image.",
                           "Yes, there exists anomalies in the image."] * (n // 2)}


def _port_myriad(params, weights="bf16", max_txt=MAX_TXT):
    from myriad_tpu_torch.models.llama import LlamaConfig

    pm = Myriad(MyriadArch.tiny(llama=LlamaConfig.tiny(weight_dtype=weights)),
                policy=Policy.fp32(), device="cpu", use_lora=True, use_ve=False,
                max_txt_len=max_txt, end_sym="###", training=True)
    pm.load_state_dicts(state_dict_from_jax(params), None)
    return pm


@pytest.fixture(scope="module")
def models():
    """The JAX models of the three step cases (fp32, perturbed weights) and
    each case's arrays, prepared by the port (the JAX package's arrays are
    the same: ``tests/test_torch_train.py``)."""
    jm = TracedInitMyriad(arch=JaxArch.tiny(), use_ve=False, use_lora=True,
                          policy=JaxPolicy.fp32(), max_txt_len=MAX_TXT, end_sym="###")
    params = _perturb(jax.tree_util.tree_map(np.asarray, jm.params), np.random.default_rng(0))
    jm.trainable, jm.frozen = jax_ckpt.split_by_predicate(params, jm._trainable_predicate())
    q_params = dict(params, llama=jax_quant.quantize_tree(params["llama"]))
    jv = _jax_variant(jm, llama=dataclasses.replace(jm.arch.llama, weight_dtype="int8"),
                      params=q_params)
    arrays, (stage,) = _port_myriad(params).prepare_train_arrays(_samples(ROWS),
                                                                 np.random.default_rng(1))
    # a constant map: the map encoders' max pools then tie in both packages
    # alike (tests/test_torch_train.py's ``batch``)
    arrays = dict(arrays, maps=torch.full_like(arrays["maps"], 0.537))
    jg = TracedInitMiniGPT4.from_config(JaxConfigDict(MINIGPT4_CFG))
    g_params = _perturb(jax.tree_util.tree_map(np.asarray, jg.params), np.random.default_rng(2))
    jg.trainable, jg.frozen = jax_ckpt.split_by_predicate(g_params, jg._trainable_predicate())
    pg = MiniGPT4.from_config(ConfigDict(MINIGPT4_CFG), device="cpu", training=True)
    rng = np.random.default_rng(11)
    g_samples = {"image": rng.normal(size=(ROWS, 28, 28, 3)).astype(np.float32),
                 "text_input": ["a photo of a red bridge over water", "two cats", "x" * 40,
                                "a gray screw"]}
    g_arrays, g_static = pg.prepare_train_arrays(g_samples, np.random.default_rng(7))
    assert g_arrays["before"].numel() > 0  # a prompt of the list
    return {"float": (jm, params, arrays, (stage,)), "int8": (jv, q_params, arrays, (stage,)),
            "minigpt4": (jg, g_params, g_arrays, g_static)}


def _one_process_runner(params, workdir, sub, **run):
    model = _port_myriad(params, max_txt=RUNNER_TXT)
    run = dict(run_config(workdir, sub, WORLD // N_MODEL * LOCAL_BS), max_epoch=1,
               iters_per_epoch=2, max_grad_norm=CLIP, **run)
    cfg = types.SimpleNamespace(run_cfg=run, to_dict=lambda: {"run": run})
    return PortRunner(cfg, ImageTextPretrainTask(), model,
                      {"synthetic": {"train": DeterministicDataset()}}, job_id="one")


@pytest.fixture(scope="module")
def launched(tmp_path_factory, models):
    """The four ranks started on every case, then the one-process runner
    trained beside them (its ring, which the ranks resume last, announced
    by a file)."""
    tmp = tmp_path_factory.mktemp("tp_train")
    _, params, _, _ = models["float"]
    steps = {}
    for name, (_, p, arrays, static) in models.items():
        case = {"model": "mini_gpt4" if name == "minigpt4" else "myriad",
                "state": state_dict_from_jax(p), "arrays": arrays, "static": static,
                "rows": ROWS, "max_txt": MAX_TXT}
        if name == "minigpt4":
            case["cfg"] = MINIGPT4_CFG
        if name == "int8":
            case["weights"] = "int8"
        if name == "float":
            case.update(clip=CLIP, lr=LR)
        steps[name] = case
    inputs = tmp / "inputs.pt"
    one_ring = tmp / "one" / "one" / "checkpoint_0"
    torch.save({"workdir": str(tmp / "ranks"), "steps": steps,
                "runner": {"state": state_dict_from_jax(params), "max_txt": RUNNER_TXT,
                           "clip": CLIP, "local_bs": LOCAL_BS, "one_ring": str(one_ring),
                           "one_ready": str(tmp / "one_ready")}}, inputs)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    for key in ("MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    procs = [(subprocess.Popen([sys.executable, WORKER, str(r), str(WORLD), str(tmp / "store"),
                                str(inputs), str(tmp / f"out{r}.pt")],
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                               env=env, cwd=REPO), tmp / f"out{r}.pt") for r in range(WORLD)]
    t_start = time.time()
    one = _one_process_runner(params, str(tmp), "one")
    one.train()
    assert os.path.join(one.output_dir, "checkpoint_0") == str(one_ring)
    (tmp / "one_ready").write_text("1")
    return procs, t_start, one, tmp


def _gspmd_step(jm, arrays, static):
    """The JAX runner's placement and step: trees over ``myriad_rules`` on a
    data 4 x model 2 mesh, the batch over the data axis, one jitted
    ``value_and_grad`` of ``pure_loss``.  (loss, gradients by port name, the
    JAX gradient tree)."""
    mesh = jax_mesh.make_mesh(n_model=N_MODEL)
    rules = jax_partition.myriad_rules()
    tr = jax.device_put(jm.trainable, jax_partition.tree_shardings(jm.trainable, mesh, rules))
    fr = jax.device_put(jm.frozen, jax_partition.tree_shardings(jm.frozen, mesh, rules))
    placed = {k: jax_mesh.put_sharded(
        jnp.asarray(v.numpy()), jax_mesh.replicated(mesh) if k in ("before", "after")
        else jax_mesh.data_sharding(mesh, v.dim())) for k, v in arrays.items()}
    step = jax.jit(jax.value_and_grad(lambda t, f, a: jm.pure_loss(t, f, a, static)))
    loss, grads = step(tr, fr, placed)
    return float(loss), state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads)), grads


@pytest.fixture(scope="module")
def jax_steps(models):
    """Each case's GSPMD step, and optax's clipped AdamW step of the float one."""
    out, raw = {}, {}
    for name, (jm, _, arrays, static) in models.items():
        loss, grads, raw[name] = _gspmd_step(jm, arrays, static)
        out[name] = (loss, grads)
    jm = models["float"][0]
    tx = jax_optim.make_optimizer(lambda count: LR, weight_decay=0.05, max_grad_norm=CLIP)

    @jax.jit
    def clipped_step(grads, params):
        updates, _ = tx.update(grads, tx.init(params), params)
        return optax.global_norm(grads), jax.tree_util.tree_map(lambda p, u: p + u, params,
                                                                updates)

    grads = jax.tree_util.tree_map(np.asarray, raw["float"])
    norm, stepped = clipped_step(grads, jax.tree_util.tree_map(np.asarray, jm.trainable))
    out["clip"] = (float(norm),
                   state_dict_from_jax(jax.tree_util.tree_map(np.asarray, stepped)))
    return out


@pytest.fixture(scope="module")
def ranks(launched, jax_steps):
    """The four ranks' results (the JAX steps ran while they trained)."""
    procs, t_start, _, _ = launched
    results = []
    try:
        for proc, out in procs:
            left = max(RANK_WALL_S - (time.time() - t_start), 1.0)
            try:
                log, _ = proc.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                pytest.fail(f"a rank ran past {RANK_WALL_S} s")
            assert proc.returncode == 0, f"rank failed:\n{log[-4000:]}"
            results.append(torch.load(out, weights_only=False))
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return results


def test_ranks_form_a_data_by_model_mesh(ranks):
    """Model groups of two consecutive ranks, data groups across them; the
    data axis that the sums, the sampler and the seeds follow; a model axis
    of 3 refused in a world of 4."""
    assert [(r["data_rank"], r["model_rank"]) for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [r["data_axis"] for r in ranks] == [[0, 2], [0, 2], [1, 2], [1, 2]]
    assert all(r["backend"] == "gloo" for r in ranks)
    assert all("4 ranks not divisible by model axis 3" in r["refused"] for r in ranks)


@pytest.mark.parametrize("fn", ["copy_to_model", "reduce_from_model", "gather_from_model",
                                "broadcast_from_lead"])
def test_autograd_collectives_match_their_definitions(ranks, fn):
    assert all(r["collectives"][fn] for r in ranks)


def _slice(whole, dims, name, model_rank):
    d = dims.get(name)
    if d is None:
        return whole
    w = whole.shape[d] // N_MODEL
    return whole.narrow(d, model_rank * w, w)


@pytest.mark.parametrize("case", ["float", "int8", "minigpt4"])
def test_step_matches_the_jax_gspmd_step(case, ranks, jax_steps, models):
    """The global loss on every rank within 1e-5 of the JAX step's; every
    trainable's reduced gradient within 1e-4: a shard against the JAX
    gradient's slice on the rank's model index, ``lora_a`` (each rank's part
    summed over the group) and the other replicated ones against the whole;
    replicated gradients the same bits on every rank."""
    ref_loss, ref = jax_steps[case]
    jm = models[case][0]
    res = [r["steps"][case] for r in ranks]
    assert len({x["loss"] for x in res}) == 1
    assert abs(res[0]["loss"] - ref_loss) <= 1e-5 * abs(ref_loss), (res[0]["loss"], ref_loss)
    names = set(state_dict_from_jax(jm.trainable))
    assert set(res[0]["grads"]) == names
    dims = res[0]["split_dims"]
    if case == "minigpt4":
        assert names == {"llama_proj.weight", "llama_proj.bias"} and not dims
    else:
        assert set(dims) == {n for n in names if ".lora_b." in n} and set(dims.values()) == {0}
        assert any(".lora_a." in n for n in names)
    for r, x in zip(ranks, res):
        worst = {}
        for n, g in x["grads"].items():
            want = _slice(torch.as_tensor(ref[n]), dims, n, r["model_rank"])
            assert tuple(g.shape) == tuple(want.shape), n
            if float(want.norm()) > 0:
                worst[n] = _rel(g.numpy(), want.numpy())
            else:  # the stage's unused map encoder: zero on both sides
                assert float(g.norm()) == 0, n
        assert max(worst.values()) <= 1e-4, sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    for n, g in res[0]["grads"].items():
        twins = [x["grads"][n] for r, x in zip(ranks, res)
                 if n not in dims or r["model_rank"] == 0]
        assert all(torch.equal(g, t) for t in twins), n
    calls = res[0]["calls"]
    layers = JaxArch.tiny().llama.num_layers
    # one all-reduce of dx a block's attention and MLP, one at the head; the
    # lead's image tokens; the replicated gradients over the world, the
    # loss's parts and the shards' gradients over the data group
    assert calls["all_reduce_sum_grad"] == 2 * layers + 1, calls
    assert calls["broadcast"] == 1 and calls["world_sum"] == 1, calls
    assert calls["data_sum"] == (1 if case == "minigpt4" else 2), calls


def test_clip_by_global_norm_counts_each_shard_once(ranks, jax_steps):
    """The global norm over the shards (their squares summed over the model
    group, the replicated ones once) is optax's; one clipped AdamW step from
    the reduced gradients is ``make_optimizer``'s (the whole trees)."""
    norm, stepped = jax_steps["clip"]
    for r in ranks:
        x = r["steps"]["float"]
        assert abs(x["norm"] - norm) <= 1e-5 * norm, (x["norm"], norm)
        assert norm > 10 * CLIP
        worst = max(_rel(x["stepped"][n].numpy(), stepped[n]) for n in stepped)
        assert worst <= 1e-5, worst
        assert all(torch.equal(x["stepped"][n], ranks[0]["steps"]["float"]["stepped"][n])
                   for n in stepped)


def test_runner_trains_as_one_process_at_the_same_global_batch(ranks, launched):
    """Two clipped steps of ``RunnerBase`` with ``model_shards: 2`` (4 rows a
    data group) against the one-process runner at 8 rows over the same rows:
    losses within 1e-5, the trainables gathered whole within 1e-4, and every
    rank of the mesh holding the same whole trainables."""
    _, _, one, _ = launched
    assert len(one.losses) == 2
    want = {n: p.detach() for n, p in one.model.trainable_parameters()}
    for r in ranks:
        x = r["runner"]
        assert (x["model_rank"], x["data_rank"], x["n_data"]) == (r["model_rank"],
                                                                  r["data_rank"], 2)
        for ours, theirs in zip(x["losses"], one.losses):
            assert abs(ours - theirs) <= 1e-5 * abs(theirs), (x["losses"], one.losses)
        worst = max(_rel(x["whole"][n].numpy(), t.numpy()) for n, t in want.items())
        assert worst <= 1e-4, worst
        for n, t in x["whole"].items():
            assert torch.equal(t, ranks[0]["runner"]["whole"][n]), n
            assert torch.equal(x["pieces"][n], _slice(t, x["split_dims"], n, r["model_rank"]))


def test_ring_is_whole_and_resumes_both_ways(ranks, launched, models):
    """Rank 0 writes one ring, whole: every leaf of its model and optimizer
    trees has the one-process ring's shape.  Every rank resumes it re-sharded
    (trainables, mu, nu, epoch and step bit for bit), one process resumes it
    whole, and the ranks resume the one-process ring to their slices of it."""
    _, _, one, tmp = launched
    ring = ranks[0]["runner"]["ring"]
    assert all(r["runner"]["ring"] == ring for r in ranks)
    mine = ckpt_lib.load_params(ring)
    theirs = ckpt_lib.load_params(os.path.join(one.output_dir, "checkpoint_0"))

    def shapes(tree):
        return [(jax.tree_util.keystr(k), np.shape(v))
                for k, v in jax.tree_util.tree_leaves_with_path(tree)]

    for key in ("model", "optimizer"):
        assert shapes(mine[key]) == shapes(theirs[key]) and shapes(mine[key]), key
    saved = {n: t for _, n, t in jax_leaves(mine["model"])}
    whole = ranks[0]["runner"]["whole"]
    for n, t in whole.items():
        assert torch.equal(torch.as_tensor(saved[n]), t), n
    for r in ranks:
        x = r["runner"]
        assert x["resumed_at"] == [1, 2, 2]
        for n in x["pieces"]:
            assert torch.equal(x["resumed"][n], x["pieces"][n]), n
            assert torch.equal(x["resumed_mu"][n], x["mu"][n]), n
            assert torch.equal(x["resumed_nu"][n], x["nu"][n]), n
    # one process resumes the ring written under the mesh
    back = _one_process_runner(models["float"][1], str(tmp), "one_resume",
                               resume_ckpt_path=ring)
    assert (back.start_epoch, back.global_step, back.optimizer.count) == (1, 2, 2)
    for n, p in back.model.trainable_parameters():
        assert torch.equal(p.detach(), whole[n]), n
    # the ranks resumed the one-process ring to their slices of it
    one_mu = dict(zip(one.optimizer.names, one.optimizer.mu))
    for r in ranks:
        x = r["runner"]
        for n, p in one.model.trainable_parameters():
            assert torch.equal(x["from_one"][n],
                               _slice(p.detach(), x["split_dims"], n, r["model_rank"])), n
            assert torch.equal(x["from_one_mu"][n],
                               _slice(one_mu[n], x["split_dims"], n, r["model_rank"])), n


def test_refusals(monkeypatch):
    """A model axis of 2 in a world of one raises (the JAX ``make_mesh``'s
    error; nothing falls back to one rank); ``make_mesh(1)`` sets no data
    axis; int4 weights refuse a gradient on a row shard as on a whole one."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="1 ranks not divisible by model axis 2"):
        dist.init_distributed_mode({"model_shards": 2}, "cpu")
    assert dist.init_distributed_mode({"model_shards": 2, "use_mesh": False}, "cpu") is None
    assert not make_mesh(1, device="cpu").sharded
    assert dist.get_data_world_size() == dist.get_world_size() == 1
    w4, s4 = quant.quantize_int4_grouped(torch.randn(8, 4))
    x = torch.randn(3, 4, requires_grad=True)
    with pytest.raises(NotImplementedError, match="llm_weight_dtype=int4"):
        quant.int4_matmul(x, w4[:2], s4, mesh=Mesh(n_model=2, model_rank=0))
