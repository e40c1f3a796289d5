"""The port's training slice against the JAX package's, on the CPU at tiny size.

* the train step: the same batch through ``prepare_train_arrays``, then the
  loss and every trainable gradient against ``jax.value_and_grad`` of
  ``Myriad.pure_loss`` (fp32, weights through ``convert_from_jax``), for a
  float LLaMA with LoRA (the config's model) and an int8 LLaMA with LoRA at
  <= 256 rows (kernel B1's route, whose plain version the CPU runs) and at
  > 256 rows (W8A8), and an int8 Q-Former (``qformer_weight_dtype: int8``):
  loss within 1e-5 relative, gradients within 1e-4 relative L2, the
  trainable names equal to the JAX split's;
* the optimizer: 5 AdamW steps (weight decay 0.05, clip 1.0, accumulation 2)
  on the tiny trainable tree within 1e-6 relative of ``make_optimizer``'s optax
  result; both schedules within 1e-7 over 50 steps;
* the checkpoint ring against the JAX manager's names and retention, the
  train -> serve loop (``ckpt:``), and ``myriad_tpu_torch.train.main`` on a
  tiny YAML (finite losses, the ring, a resume that continues the step);
* Orbax rings between the runners: the port's ring restored by orbax and
  resumed by the JAX runner's ``_resume`` (the same trainables and optax
  state), and a JAX-written ring resumed by the port equal by name, whose
  next step's loss (1e-5), gradients and updated trainables (1e-4) are the
  JAX runner's, resumed from the same directory.

Four JAX ``value_and_grad`` compiles in all (one a case; the float case's
serves the resumed step).
"""

import copy
import dataclasses
import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch

from myriad_tpu import checkpoint as jax_ckpt
from myriad_tpu.common import optim as jax_optim
from myriad_tpu.models.layers import Policy as JaxPolicy
from myriad_tpu.models.myriad import MyriadArch as JaxArch
from myriad_tpu.models.myriad import MyriadModule as JaxMyriadModule
from myriad_tpu.ops import quant as jax_quant
from myriad_tpu.runners.runner_base import RunnerBase as JaxRunner
from myriad_tpu.tasks.image_text_pretrain import ImageTextPretrainTask as JaxTask
from myriad_tpu_torch import checkpoint as ckpt_lib
from myriad_tpu_torch.common import optim
from myriad_tpu_torch.convert_from_jax import state_dict_from_jax
from myriad_tpu_torch.models.layers import Policy
from myriad_tpu_torch.models.llama import LlamaConfig
from myriad_tpu_torch.models.myriad import Myriad, MyriadArch
from myriad_tpu_torch.ops import quant
from myriad_tpu_torch.runners.runner_base import RunnerBase as PortRunner
from test_torch_myriad import SCENES, TracedInitMyriad, _jax_variant, _perturb
from test_torch_orbax import _cfg, _equal_named, _opt_by_name, _port_opt
import torch_threads  # noqa: F401  (one torch thread a test process)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUESTION = "<Img><ImageHere></Img>Any defect?"
MAX_TXT = 16


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tiny models' ops on one thread: under the suite's parallel workers
    torch's default of a thread a core oversubscribes the host, and the
    spinning threads slow these tests several times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    """A tiny JAX Myriad with LoRA (fp32, perturbed weights) and the port
    built for training from the same weights."""
    jm = TracedInitMyriad(arch=JaxArch.tiny(), use_ve=True, use_lora=True,
                          policy=JaxPolicy.fp32(), max_txt_len=MAX_TXT, end_sym="###")
    rng = np.random.default_rng(0)
    params = _perturb(jax.tree_util.tree_map(np.asarray, jm.params), rng)
    jm.trainable, jm.frozen = jax_ckpt.split_by_predicate(params, jm._trainable_predicate())
    ve = jm.vision_expert
    ve.params = {"params": _perturb(jax.tree_util.tree_map(np.asarray, ve.params["params"]),
                                    rng)}
    ve.class_names = SCENES
    ve.class_index = {c: i for i, c in enumerate(SCENES)}
    ve.build_text_features()
    pm = _port(MyriadArch.tiny(), params, state_dict_from_jax(ve.params["params"]))
    return jm, pm


def _port(arch, params, ve_state):
    pm = Myriad(arch, policy=Policy.fp32(), device="cpu", class_names=SCENES, use_lora=True,
                max_txt_len=MAX_TXT, end_sym="###", training=True)
    pm.load_state_dicts(state_dict_from_jax(params), ve_state)
    return pm


def _samples(n):
    rng = np.random.default_rng(5)
    img = lambda: rng.normal(size=(n, 28, 28, 3)).astype(np.float32)
    return {"image": img(), "aug_image": img(), "scene": SCENES[:n],
            "question": [QUESTION] * n, "question2": [QUESTION] * n,
            "question3": [QUESTION] * n,
            "text_input": ["No, there exists no anomalies in the image."] * n,
            "aug_text_input": ["Yes, there exists anomalies in the image."] * n}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@functools.lru_cache(maxsize=None)
def _loss_and_grads(jm, stage):
    """``jm``'s jitted loss and gradient at ``stage``: one compile for every
    test that steps the same model."""
    return jax.jit(jax.value_and_grad(lambda tr, fr, a: jm.pure_loss(tr, fr, a, (stage,))))


def _jax_grads(jm, arrays, stage):
    jarrays = {k: jnp.asarray(v.numpy()) for k, v in arrays.items()}
    loss, grads = _loss_and_grads(jm, stage)(jm.trainable, jm.frozen, jarrays)
    return float(loss), state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads))


def _port_grads(pm, arrays, stage):
    for _, p in pm.trainable_parameters():
        p.grad = None
    loss = pm.train_loss(arrays, (stage,))
    loss.backward()
    return float(loss.detach()), {
        n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        for n, p in pm.trainable_parameters()}


def _check_step(jm, pm, arrays, stage):
    ref_loss, ref = _jax_grads(jm, arrays, stage)
    loss, grads = _port_grads(pm, arrays, stage)
    assert set(grads) == set(ref)
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss), (loss, ref_loss)
    worst = {n: _rel(grads[n], ref[n]) for n in ref if np.linalg.norm(ref[n]) > 0}
    assert max(worst.values()) <= 1e-4, sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    for n in ref:  # the stage's unused map encoder: zero on both sides
        if np.linalg.norm(ref[n]) == 0:
            assert np.linalg.norm(grads[n]) == 0, n
    assert any(re.search(r"lora_[ab]", n) for n in worst)
    return loss


@pytest.fixture(scope="module")
def batch(pair):
    """The same 2 + 2 image batch through both ``prepare_train_arrays``."""
    jm, pm = pair
    samples = _samples(2)
    ref, (jstage,) = jm.prepare_train_arrays(samples, np.random.default_rng(1))
    arrays, (stage,) = pm.prepare_train_arrays(samples, np.random.default_rng(1))
    assert stage == jstage
    for k in ("image", "before", "after", "text_ids", "text_mask"):
        np.testing.assert_array_equal(arrays[k].numpy(), np.asarray(ref[k]), err_msg=k)
    np.testing.assert_allclose(arrays["maps"].numpy(), np.asarray(ref["maps"]), rtol=1e-5,
                               atol=1e-5)
    # the map encoders' 2x2 max pools route a gradient to the larger of two
    # near-equal activations, which the two packages' convolutions order by
    # their rounding: on the tiny vision expert's maps (0.537 +- 1e-3) or on
    # random ones a few windows in 10^4 route differently and move the
    # pyramids' gradients by 1e-3.  On a constant map every interior window
    # is an exact tie, which both send to its first cell, so the step is
    # compared there
    return dict(arrays, maps=torch.full_like(arrays["maps"], 0.537))


def test_trainable_names_are_the_jax_split(pair):
    jm, pm = pair
    assert set(pm.trainable_names) == set(state_dict_from_jax(jm.trainable))
    assert all(p.requires_grad == (n in pm.trainable_names)
               for n, p in pm.module.named_parameters())
    assert not any(p.requires_grad for p in pm.vision_expert.module.parameters())


def test_train_step_float_lora_matches_jax(pair, batch):
    """The config's model: a float LLaMA with LoRA, prompt stage 1 (both map
    encoders), 4 sequences."""
    jm, pm = pair
    _check_step(jm, pm, batch, 1)


def _int8_pair(jm, pm):
    params = jax.tree_util.tree_map(np.asarray, jm.params)
    params["llama"] = jax_quant.quantize_tree(params["llama"])
    jv = _jax_variant(jm, llama=dataclasses.replace(jm.arch.llama, weight_dtype="int8"),
                      params=params)
    pv = _port(MyriadArch.tiny(llama=LlamaConfig.tiny(weight_dtype="int8")), params,
               pm.vision_expert.module.state_dict())
    return jv, pv


@pytest.mark.parametrize("route", ["b1", "w8a8"])
def test_train_step_int8_lora_matches_jax(pair, batch, route, monkeypatch):
    """An int8 LLaMA with LoRA through the straight-through backward: <= 256
    rows take B1's route (the JAX package's Pallas kernel in interpret mode,
    the port's plain B1, as its row rule sends them on the card), more rows
    W8A8 on both sides."""
    jm, pm = pair
    jv, pv = _int8_pair(jm, pm)
    if route == "b1":
        arrays = {k: (v[::2] if k in ("image", "maps", "text_ids", "text_mask") else v)
                  for k, v in batch.items()}
        stage, rows = 2, 2 * (1 + batch["before"].shape[0] + 8 + 49
                              + batch["after"].shape[0] + MAX_TXT)
        assert rows <= quant.SMALL_M
        monkeypatch.setattr(jax_quant, "int8_matmul",
                            functools.partial(jax_quant.int8_matmul, interpret=True))
        monkeypatch.setattr(quant, "takes_kernel", lambda x2: x2.shape[0] <= quant.SMALL_M)
        launches = []
        monkeypatch.setattr(quant, "int8_weight_only_matmul",
                            lambda *a: launches.append(1) or quant.int8_weight_only_matmul_plain(*a))
    else:
        arrays, stage = batch, 1
        launches = None
    _check_step(jv, pv, arrays, stage)
    if launches is not None:
        assert len(launches) == 2 * 7  # every projection of both layers took B1's route


def test_train_step_int8_qformer_matches_jax(pair, batch):
    """``qformer_weight_dtype: int8`` (the TPU harness's tower profile) under
    training: the gradients of the VE instructor and the expert adaptor
    cross the frozen int8 Q-Former by the straight-through rule (W8A8 on
    both sides on the CPU; on the card, <= 256 rows take B1's route)."""
    jm, pm = pair
    params = jax.tree_util.tree_map(np.asarray, jm.params)
    params["qformer"] = jax_quant.quantize_tree(params["qformer"],
                                                jax_quant.QFORMER_QUANT_PATTERN)
    jv = _jax_variant(jm)
    jv.arch = dataclasses.replace(jm.arch, qformer_weight_dtype="int8")
    jv.module = JaxMyriadModule(jv.arch, dtype=jm.policy.compute_dtype,
                                param_dtype=jm.policy.param_dtype)
    jv.trainable, jv.frozen = jax_ckpt.split_by_predicate(params, jv._trainable_predicate())
    pv = _port(MyriadArch.tiny(qformer_weight_dtype="int8"), params,
               pm.vision_expert.module.state_dict())
    assert pv.module.qformer.layer[0].attention.query.w_int8.dtype == torch.int8
    _check_step(jv, pv, batch, 1)
    grads = _port_grads(pv, batch, 1)[1]
    for name in ("ve_instructor", "expert_adaptor"):
        assert any(n.startswith(name) and np.linalg.norm(g) > 0 for n, g in grads.items())


def test_straight_through_backward_is_the_dequantized_product():
    """dx = (dy * scale) @ w8^T on both routes; w8 and scale get no gradient;
    int4 weights refuse a gradient."""
    g = torch.Generator().manual_seed(0)
    w8, scale = quant.quantize_per_channel(torch.randn(24, 40, generator=g))
    for rows in (5, 300):
        x = torch.randn(rows, 24, generator=g, requires_grad=True)
        y = quant.int8_matmul(x, w8, scale)
        dy = torch.randn(y.shape, generator=g)
        y.backward(dy)
        torch.testing.assert_close(x.grad, (dy * scale) @ w8.float().t(), rtol=1e-6, atol=1e-6)
    w4, s4 = quant.quantize_int4_grouped(torch.randn(24, 40, generator=g))
    with pytest.raises(NotImplementedError, match="llm_weight_dtype=int4"):
        quant.int4_matmul(torch.randn(3, 24, requires_grad=True), w4, s4)


def test_remat_and_grad_checkpoint_keep_the_gradients(pair, batch):
    """``use_grad_checkpoint`` (LLaMA remat, EVA's per-block checkpoint) gives
    the same loss and gradients."""
    jm, pm = pair
    loss, grads = _port_grads(pm, batch, 1)
    remat = Myriad(MyriadArch.tiny(), policy=Policy.fp32(), device="cpu", class_names=SCENES,
                   use_lora=True, max_txt_len=MAX_TXT, end_sym="###", training=True,
                   use_grad_checkpoint=True)
    assert remat.arch.llama.remat and remat.module.visual_encoder.use_checkpoint
    remat.load_state_dicts(pm.module.state_dict(), pm.vision_expert.module.state_dict())
    loss2, grads2 = _port_grads(remat, batch, 1)
    assert loss2 == loss
    for n in grads:
        np.testing.assert_allclose(grads2[n], grads[n], rtol=1e-6, atol=1e-9, err_msg=n)


def test_adamw_matches_optax(pair):
    """5 steps of clip 1.0 -> AdamW (weight decay 0.05 on ndim >= 2) with 2
    accumulated gradients each, on the tiny trainable tree."""
    jm, pm = pair
    sched = dict(init_lr=1e-3, min_lr=0.0, max_epoch=2, iters_per_epoch=5, warmup_steps=2,
                 warmup_start_lr=1e-5)
    tx = jax_optim.make_optimizer(jax_optim.build_schedule("linear_warmup_cosine_lr", **sched),
                                  weight_decay=0.05, max_grad_norm=1.0, accum_grad_iters=2)
    jparams = jax.tree_util.tree_map(jnp.asarray, jm.trainable)
    state = tx.init(jparams)
    ref_names = state_dict_from_jax(jm.trainable)
    tparams = [(n, torch.tensor(v.numpy()).clone()) for n, v in ref_names.items()]
    opt = optim.AdamW(tparams, optim.build_schedule("linear_warmup_cosine_lr", **sched),
                      weight_decay=0.05, max_grad_norm=1.0, accum_grad_iters=2)
    rng = np.random.default_rng(9)
    leaves, treedef = jax.tree_util.tree_flatten(jm.trainable)

    @jax.jit
    def update(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return jax.tree_util.tree_map(lambda p, u: p + u, params, updates), state

    for _ in range(10):
        gl = [(rng.normal(size=np.shape(x)) * 0.3).astype(np.float32) for x in leaves]
        jgrads = jax.tree_util.tree_unflatten(treedef, gl)
        jparams, state = update(jgrads, state, jparams)
        for (n, p), g in zip(tparams, state_dict_from_jax(jgrads).values()):
            p.grad = g
        opt.step()
    assert opt.count == 5
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    for n, p in tparams:
        assert _rel(p.numpy(), ref[n]) <= 1e-6, n


@pytest.mark.parametrize("name", ["linear_warmup_cosine_lr", "linear_warmup_step_lr"])
def test_schedules_match_jax(name):
    kw = dict(init_lr=1e-4, min_lr=1e-6, max_epoch=3, iters_per_epoch=10, warmup_steps=7,
              warmup_start_lr=1e-6, decay_rate=0.5)
    ref, ours = jax_optim.build_schedule(name, **kw), optim.build_schedule(name, **kw)
    for t in range(50):
        assert abs(ours(t) - float(ref(t))) <= 1e-7, t


def test_checkpoint_ring_matches_jax(tmp_path):
    """The same saves give the same surviving tags as the JAX manager's."""
    tags = [0, 1, "best", 2, "3", 4]
    jm = jax_ckpt.CheckpointManager(str(tmp_path / "jax"), max_checkpoints=2)
    pm = ckpt_lib.CheckpointManager(str(tmp_path / "port"), max_checkpoints=2)
    for t in tags:
        jm.save(t, {"x": np.zeros(2, np.float32)})
        pm.save(t, {"model": {"x": torch.zeros(2)}, "epoch": 0})
    jax_names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == jax_names
    assert jax_names == ["checkpoint_3", "checkpoint_4", "checkpoint_best"]


# -- Orbax rings between the two runners, on the pair (the rest of the Orbax
# tests: tests/test_torch_orbax.py) ------------------------------------------
def _jax_model(jm):
    """A copy of the pair's JAX model whose trainables a resume replaces."""
    return copy.copy(jm)


def test_port_ring_restored_by_orbax_and_resumed_by_jax(pair, tmp_path):
    """The port's ``_save_checkpoint`` after two AdamW steps: orbax restores
    the JAX runner's state ({model, optimizer, epoch, global_step}, the
    optax tree of ``make_optimizer``), and the JAX runner's ``_resume``
    (``accum_grad_iters: 1``, clipping on) takes the same trainables and
    optax state."""
    jm, pm = pair
    runner = PortRunner(_cfg(tmp_path, "port", max_grad_norm=1.0), None, pm, {})
    before = {n: p.detach().clone() for n, p in pm.trainable_parameters()}
    g = torch.Generator().manual_seed(4)
    for _ in range(2):
        for _, p in pm.trainable_parameters():
            p.grad = torch.randn(p.shape, generator=g) * 0.1
        runner.optimizer.step()
        runner.global_step += 1
    path = runner._save_checkpoint(0)
    saved = {n: p.detach().clone() for n, p in pm.trainable_parameters()}
    with torch.no_grad():  # leave the pair as it was
        for n, p in pm.trainable_parameters():
            p.copy_(before[n])
            p.grad = None
    restored = ocp.StandardCheckpointer().restore(path)
    assert (int(restored["epoch"]), int(restored["global_step"])) == (0, 2)
    assert restored["optimizer"][0] is None  # clip_by_global_norm's empty state
    jr = JaxRunner(_cfg(tmp_path, "jax", max_grad_norm=1.0,
                        resume_ckpt_path=path), JaxTask(), _jax_model(jm), {})
    _equal_named(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jr.model.trainable)),
                 saved)
    count, mu, nu = _opt_by_name(jr._opt_state)
    ours = _port_opt(runner.optimizer)
    assert count == ours[0] == 2
    _equal_named(ours[1], mu)
    _equal_named(ours[2], nu)
    assert (jr.start_epoch, jr.global_step) == (1, 2)


def test_port_resumes_a_jax_ring_and_steps_as_jax(pair, batch, tmp_path):
    """A JAX-written ring (the JAX ``CheckpointManager``, after two optax
    updates of the pair's trainables): the port's ``_resume`` takes the
    trainables and Adam's state equal by name; one more step on the same
    batch gives the JAX runner's loss (1e-5), gradients (1e-4) and updated
    trainables (1e-4), the JAX runner resumed from the same directory."""
    jm, pm = pair
    jr0 = JaxRunner(_cfg(tmp_path, "jax0"), JaxTask(), _jax_model(jm), {})
    tx = jr0.tx
    params = jax.tree_util.tree_map(jnp.asarray, jm.trainable)
    opt = tx.init(params)
    update = jax.jit(tx.update)  # one compile; eager optax compiles every op
    rng = np.random.default_rng(8)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(0, 0.05, p.shape).astype(np.float32)), params)
        updates, opt = update(grads, opt, params)
        params = optax.apply_updates(params, updates)
    jr0.model.trainable, jr0._opt_state, jr0.global_step = params, opt, 2
    jr0._save_checkpoint(1)
    path = os.path.join(jr0.output_dir, "checkpoint_1")

    jr = JaxRunner(_cfg(tmp_path, "jax", resume_ckpt_path=path), JaxTask(), _jax_model(jm), {})
    before = {n: p.detach().clone() for n, p in pm.trainable_parameters()}
    pr = PortRunner(_cfg(tmp_path, "port", resume_ckpt_path=path), None, pm, {})
    try:
        assert (pr.start_epoch, pr.global_step) == (jr.start_epoch, jr.global_step) == (2, 2)
        _equal_named(pm.trainable_state_dict(),
                     state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jr.model.trainable)))
        count, mu, nu = _opt_by_name(jr._opt_state)
        ours = _port_opt(pr.optimizer)
        assert ours[0] == count == 2
        _equal_named(ours[1], mu)
        _equal_named(ours[2], nu)

        stage = 1
        jarrays = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}

        ref_loss, ref_grads = _loss_and_grads(jm, stage)(jr.model.trainable, jm.frozen,
                                                         jarrays)
        updates, _ = update(ref_grads, jr._opt_state, jr.model.trainable)
        new = optax.apply_updates(jr.model.trainable, updates)
        pr.optimizer.zero_grad()
        loss = pm.train_loss(batch, (stage,))
        loss.backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).clone()
                 for n, p in pm.trainable_parameters()}
        pr.optimizer.step()
        loss = float(loss.detach())
        assert abs(loss - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
        ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, ref_grads))
        for n, gref in ref.items():
            if np.linalg.norm(gref.numpy()) > 0:
                assert _rel(grads[n].numpy(), gref.numpy()) <= 1e-4, n
        ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, new))
        for n, p in pm.trainable_parameters():
            assert _rel(p.detach().numpy(), ref[n].numpy()) <= 1e-4, n
    finally:
        with torch.no_grad():
            for n, p in pm.trainable_parameters():
                p.copy_(before[n])
                p.grad = None
