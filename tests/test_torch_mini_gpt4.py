"""The port's MiniGPT-4 (``myriad_tpu_torch.models.mini_gpt4``) and its stage-1
runner against the JAX package's, on the CPU at tiny size (fp32).

* the model: one JAX ``MiniGPT4.from_config`` (tiny, a prompt list from a
  prompt file and template, ``end_sym "###"``, ``max_txt_len`` 20,
  ``freeze_qformer: False``; its initialiser traced, not compiled, then
  perturbed) and the port's ``from_config`` of the same keys, loaded with
  ``convert_from_jax.state_dict_from_jax`` (``strict=True``): every key
  resolved alike (arch, the trainable split, the prompts, the targets), the
  same batch through ``prepare_train_arrays`` (the prompt drawn from one
  seed), the loss within 1e-5 relative and the ``llama_proj`` gradients
  within 1e-4 relative L2 of ``jax.value_and_grad`` (each Q-Former leaf
  within 1e-4 of the L2 norm of the Q-Former's whole gradient);
* ``load_pretrained_weights``: the same report (loaded, skipped, missing)
  for npz towers with a leaf cut and an unknown leaf added;
* the stage-1 tiny config of ``tests/test_stage1_pretrain.py`` (laion and
  cc_sbu tar shards at 115:14) through the JAX runner and through the port's
  ``train.build`` with the JAX model's initial weights: the three
  iterations' losses within 1e-5, the ratios ``[115.0, 14.0]``,
  ``train_loss`` in ``log.txt``; ``ckpt:`` of the JAX runner's ring gives
  the port the JAX run's trained ``llama_proj``, and ``resume_ckpt_path`` of it
  restores the port runner (trainables, step, optimizer count).
"""

import io
import json
import os
import tarfile

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from myriad_tpu import checkpoint as jax_ckpt
from myriad_tpu.common.config import Config as JaxConfig
from myriad_tpu.common.config import ConfigDict as JaxConfigDict
from myriad_tpu.models.mini_gpt4 import MiniGPT4 as JaxMiniGPT4
from myriad_tpu_torch import train
from myriad_tpu_torch.common.config import ConfigDict
from myriad_tpu_torch.convert_from_jax import jax_path_of, state_dict_from_jax
from myriad_tpu_torch.models.layers import Policy
from myriad_tpu_torch.models.mini_gpt4 import MiniGPT4
from test_torch_llama import _init_like
from test_torch_myriad import _perturb
import torch_threads  # noqa: F401  (one torch thread a test process)

PROMPTS = ["<Img><ImageHere></Img> Describe this image in detail.",
           "a line without the image tag",
           "<Img><ImageHere></Img> Take a look at this image and describe what you notice.",
           "<Img><ImageHere></Img> What is in it?"]
TEMPLATE = "###Human: {} ###Assistant: "


def _traced_init(self, rng):
    """The JAX initialiser traced (``jax.eval_shape``) and filled by
    ``_init_like``, not compiled: the tests overwrite the weights anyway."""
    return _init_like(jax.eval_shape(lambda r: _compiled_init(self, r), rng),
                      np.random.default_rng(100))


_compiled_init = JaxMiniGPT4._init_params


class TracedInitMiniGPT4(JaxMiniGPT4):
    _init_params = _traced_init


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(scope="module")
def model_cfg(tmp_path_factory):
    path = tmp_path_factory.mktemp("prompts") / "prompts.txt"
    path.write_text("\n".join(PROMPTS) + "\n")
    return {"arch": "mini_gpt4", "arch_preset": "tiny", "image_size": 28,
            "vit_precision": "fp32", "freeze_qformer": False, "max_txt_len": 20,
            "end_sym": "###", "prompt_path": str(path), "prompt_template": TEMPLATE,
            "use_grad_checkpoint": False, "llama_model": "", "seed": 3}


@pytest.fixture(scope="module")
def pair(model_cfg):
    jm = TracedInitMiniGPT4.from_config(JaxConfigDict(model_cfg))
    params = _perturb(jax.tree_util.tree_map(np.asarray, jm.params), np.random.default_rng(0))
    jm.trainable, jm.frozen = jax_ckpt.split_by_predicate(params, jm._trainable_predicate())
    pm = MiniGPT4.from_config(ConfigDict(model_cfg), device="cpu", training=True)
    pm.load_state_dicts(state_dict_from_jax(params))
    return jm, pm, params


def test_from_config_resolves_every_key_as_the_jax_one(pair):
    jm, pm, _ = pair
    for field in ("img_size", "vit_dim", "vit_depth", "num_query_token", "qformer_hidden",
                  "qformer_layers"):
        assert getattr(pm.arch, field) == getattr(jm.arch, field), field
    assert pm.arch.llama.hidden_size == jm.arch.llama.hidden_size
    assert pm.arch.llama.num_layers == jm.arch.llama.num_layers
    assert (pm.freeze_vit, pm.freeze_qformer, pm.freeze_llama) == (
        jm.freeze_vit, jm.freeze_qformer, jm.freeze_llama)
    assert (pm.max_txt_len, pm.end_sym) == (jm.max_txt_len, jm.end_sym) == (20, "###")
    assert pm.prompt_list == jm.prompt_list and len(pm.prompt_list) == 3
    assert pm.policy.compute_dtype == torch.float32 and pm.policy.param_dtype == torch.float32
    assert type(pm.llama_tokenizer).__name__ == type(jm.llama_tokenizer).__name__
    jax_trainable = sorted(jax_ckpt.tree_paths(jm.trainable))
    assert sorted(jax_path_of(pm.module, n) for n in pm.trainable_names) == jax_trainable
    assert any(p.startswith("qformer/") for p in jax_trainable)
    # the defaults: llama_proj alone trains, bf16 compute over fp32 trainables
    cfg = ConfigDict({"arch": "mini_gpt4", "arch_preset": "tiny"})
    dm = MiniGPT4.from_config(cfg, device="cpu")
    assert dm.trainable_names == ["llama_proj.weight", "llama_proj.bias"]
    assert dm.policy == Policy.bf16() and dm.prompt_list == [] and dm.end_sym == "\n"
    assert dm.module.llama_proj.weight.dtype == torch.float32
    assert dm.module.llama.lm_head.dtype == torch.bfloat16


def test_loss_and_llama_proj_grads_equal_the_jax_model(pair):
    jm, pm, _ = pair
    rng = np.random.default_rng(11)
    samples = {"image": rng.normal(size=(3, 28, 28, 3)).astype(np.float32),
               "text_input": ["a photo of a red bridge over water", "two cats", "x" * 40]}
    jarrays, jstatic = jm.prepare_train_arrays(samples, np.random.default_rng(7))
    arrays, static = pm.prepare_train_arrays(samples, np.random.default_rng(7))
    for k in ("before", "after", "text_ids", "text_mask"):
        np.testing.assert_array_equal(arrays[k].numpy(), np.asarray(jarrays[k]), err_msg=k)
    assert arrays["before"].numel() > 0  # a prompt of the list, not the bare image

    @jax.jit
    def loss_and_grads(trainable, frozen, arrays):
        return jax.value_and_grad(lambda t: jm.pure_loss(t, frozen, arrays, jstatic))(trainable)

    jloss, jgrads = loss_and_grads(jm.trainable, jm.frozen, jarrays)
    loss = pm.train_loss(arrays, static)
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    grads = dict(pm.trainable_parameters())
    jflat = {p: np.asarray(v) for p, v in zip(jax_ckpt.tree_paths(jgrads),
                                             jax.tree_util.tree_leaves(jgrads))}
    pairs = {}
    for name, p in grads.items():
        path = jax_path_of(pm.module, name)
        pairs[name] = (p.grad.numpy(), jflat[path].T if path.endswith("/kernel") else jflat[path])
    for name in ("llama_proj.weight", "llama_proj.bias"):
        assert _rel(*pairs[name]) <= 1e-4, (name, _rel(*pairs[name]))
    # the Q-Former's leaves against the norm of its whole gradient: some are
    # zero in exact arithmetic (a key bias shifts every score of a query alike)
    tower = [n for n in pairs if not n.startswith("llama_proj")]
    scale = np.sqrt(sum(np.sum(pairs[n][1].astype(np.float64) ** 2) for n in tower))
    for name in tower:
        g, ref = pairs[name]
        assert np.linalg.norm(g.astype(np.float64) - ref) <= 1e-4 * scale, name
    assert {n for n in grads if n.startswith("llama_proj")} == {"llama_proj.weight",
                                                               "llama_proj.bias"}
    for p in grads.values():
        p.grad = None


def test_load_pretrained_weights_report_equals_the_jax_one(pair, tmp_path):
    jm, pm, params = pair
    llama = jax.tree_util.tree_map(np.asarray, params["llama"])
    del llama["lm_head"]  # a leaf no file supplies: reported missing
    llama["extra"] = {"kernel": np.zeros((2, 2), np.float32)}  # unknown: skipped
    qformer = dict(params["qformer"], query_tokens=params["query_tokens"],
                   ln_vision=params["ln_vision"])  # a tower-local tree
    towers = {"vit": params["visual_encoder"], "qformer": qformer, "llama": llama,
              "llama_proj": {"llama_proj": params["llama_proj"]}}
    weights = {}
    for key, tree in towers.items():
        weights[key] = str(tmp_path / f"{key}.npz")
        jax_ckpt.save_params(weights[key], tree)
    ref = jm.load_pretrained_weights(dict(weights))
    got = pm.load_pretrained_weights(dict(weights))
    assert sorted(got) == sorted(ref) == ["loaded", "missing", "skipped"]
    for part in ("loaded", "skipped"):
        assert sorted(got[part]) == sorted(ref[part])
        for key in ref[part]:
            assert sorted(got[part][key]) == sorted(ref[part][key]), (part, key)
    assert sorted(got["missing"]) == sorted(ref["missing"])
    assert "llama/lm_head" in got["missing"] and got["skipped"]["llama"]
    assert got["skipped"]["qformer"] == ["qformer", "query_tokens"]  # they train


# -- stage 1 through the runners ---------------------------------------------------
def _write_shard(path, n, caption, img_size=28, seed=0):
    """``tests/test_stage1_pretrain.py``'s shards: random JPEGs with json captions."""
    rng = np.random.default_rng(seed)
    with tarfile.open(path, "w") as tar:
        for i in range(n):
            buf = io.BytesIO()
            Image.fromarray(rng.integers(0, 255, (img_size, img_size, 3), dtype=np.uint8)).save(
                buf, format="JPEG")
            for name, data in ((f"{i:05d}.jpg", buf.getvalue()),
                               (f"{i:05d}.json",
                                json.dumps({"caption": f"{caption} {i}"}).encode())):
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))


STAGE1 = """model:
  arch: mini_gpt4
  model_type: pretrain_vicuna
  arch_preset: tiny
  image_size: 28
  max_txt_len: 12
  end_sym: "###"
  vit_precision: "fp32"
datasets:
  laion:
    build_info:
      storage: "{laion}/*.tar"
    vis_processor:
      train:
        name: blip2_image_train
        image_size: 28
    text_processor:
      train:
        name: blip_caption
    sample_ratio: 115
  cc_sbu:
    build_info:
      storage: "{cc}/*.tar"
    vis_processor:
      train:
        name: blip2_image_train
        image_size: 28
    text_processor:
      train:
        name: blip_caption
    sample_ratio: 14
run:
  task: image_text_pretrain
  init_lr: 1e-3
  min_lr: 0
  max_epoch: 1
  iters_per_epoch: 3
  batch_size_train: 2
  num_workers: 0
  seed: 0
  output_dir: {out}
  prefetch: False
"""


@pytest.fixture(scope="module")
def stage1(tmp_path_factory):
    """The JAX runner's stage-1 run (its initial weights, losses and ring) and
    the config's path."""
    import myriad_tpu.datasets  # noqa: F401  (registers the builders)
    import myriad_tpu.models  # noqa: F401
    import myriad_tpu.runners  # noqa: F401
    import myriad_tpu.tasks as jtasks
    from myriad_tpu.common.registry import registry

    root = tmp_path_factory.mktemp("stage1")
    for d in ("laion", "cc"):
        (root / d).mkdir()
    _write_shard(str(root / "laion" / "00000.tar"), 6, "laion cap", seed=1)
    _write_shard(str(root / "cc" / "00000.tar"), 6, "cc cap", seed=2)
    cfg_path = root / "stage1.yaml"
    cfg_path.write_text(STAGE1.format(laion=root / "laion", cc=root / "cc", out=root / "jax"))
    cfg = JaxConfig(cfg_path=str(cfg_path))
    task = jtasks.setup_task(cfg)
    JaxMiniGPT4._init_params = _traced_init
    try:
        model = task.build_model(cfg)
    finally:
        JaxMiniGPT4._init_params = _compiled_init
    params = _perturb(jax.tree_util.tree_map(np.asarray, model.params), np.random.default_rng(1))
    model.trainable, model.frozen = jax_ckpt.split_by_predicate(
        params, model._trainable_predicate())
    runner = registry.get_runner_class("runner_base")(
        cfg=cfg, task=task, model=model, datasets=task.build_datasets(cfg), job_id="s1")
    losses, step = [], runner.train_iteration

    def record(samples, rng):
        loss, lr = step(samples, rng)
        losses.append(float(loss))
        return loss, lr

    runner.train_iteration = record
    runner.train()
    trained = jax.tree_util.tree_map(np.asarray, runner.model.trainable)
    return {"cfg": str(cfg_path), "root": root, "params": params, "losses": losses,
            "trained": trained, "ring": os.path.join(runner.output_dir, "checkpoint_0"),
            "ratios": runner._train_ratios}


def test_stage1_runner_losses_equal_the_jax_runner(stage1):
    runner = train.build(["--cfg-path", stage1["cfg"], "--options", "run.device=cpu",
                          f"run.output_dir={stage1['root'] / 'port'}"])
    assert isinstance(runner.model, MiniGPT4) and runner.model.device.type == "cpu"
    assert sorted(runner.datasets) == ["cc_sbu", "laion"]
    assert runner.datasets["laion"]["train"].sample_ratio == 115.0
    runner.model.load_state_dicts(state_dict_from_jax(stage1["params"]))
    runner.train()
    assert runner._train_ratios == stage1["ratios"] == [115.0, 14.0]
    assert len(runner.losses) == len(stage1["losses"]) == 3
    for got, ref in zip(runner.losses, stage1["losses"]):
        assert abs(got - ref) <= 1e-5 * abs(ref), (runner.losses, stage1["losses"])
    with open(os.path.join(runner.output_dir, "log.txt")) as f:
        assert any("train_loss" in line for line in f)
    assert sorted(os.listdir(runner.output_dir)) == ["checkpoint_0", "log.txt"]


def test_ckpt_of_the_jax_ring_loads_its_llama_proj(stage1):
    cfg = ConfigDict({"arch": "mini_gpt4", "arch_preset": "tiny", "image_size": 28,
                      "vit_precision": "fp32", "ckpt": stage1["ring"]})
    pm = MiniGPT4.from_config(cfg, device="cpu")
    pm.init_random(0)
    proj = stage1["trained"]["llama_proj"]
    np.testing.assert_array_equal(pm.module.llama_proj.weight.detach().numpy(),
                                  proj["kernel"].T)
    np.testing.assert_array_equal(pm.module.llama_proj.bias.detach().numpy(), proj["bias"])
    assert not np.array_equal(proj["kernel"], stage1["params"]["llama_proj"]["kernel"])


def test_port_runner_resumes_the_jax_ring(stage1):
    runner = train.build(["--cfg-path", stage1["cfg"], "--options", "run.device=cpu",
                          f"run.output_dir={stage1['root'] / 'resumed'}",
                          f"run.resume_ckpt_path={stage1['ring']}"])
    proj = stage1["trained"]["llama_proj"]
    np.testing.assert_array_equal(runner.model.module.llama_proj.weight.detach().numpy(),
                                  proj["kernel"].T)
    np.testing.assert_array_equal(runner.model.module.llama_proj.bias.detach().numpy(),
                                  proj["bias"])
    assert (runner.start_epoch, runner.global_step, runner.optimizer.count) == (1, 3, 3)
