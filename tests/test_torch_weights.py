"""The port's int8 towers and weight loading against the JAX package's, on the
CPU in fp32 at ``MyriadArch.tiny``.

* ``ops.quant.quantize_tree`` over each tower's float tree: int8 and int4
  payloads byte-identical to the JAX ``quantize_tree``'s, scales within one
  fp32 ulp.
* Each int8 tower (EVA-ViT, the Q-Former, ImageBind vision and text) built
  from one float tree quantized by each side's ``quantize_tree``: the
  ``w_int8`` bytes identical, activations within 1e-5.
* The whole tiny Myriad with ``vit_weight_dtype``, ``qformer_weight_dtype``
  and ``ve_weight_dtype`` int8 and every tower given under ``weights:`` as
  npz files the JAX ``save_params`` wrote (the LLaMA's quantized on load):
  both ``from_config``s give the same parameters, the same load report,
  token ids identical and VE maps within 1e-5.  A raw BLIP-2 ``.pth`` as
  ``q_former_model`` and an npz ``ckpt:`` (bare, or a runner ring's
  ``model``) against that JAX model with the JAX load applied on top (what
  its ``from_config`` does after the towers), sharing its compiled programs;
  the same for ``ckpt:`` a JAX-written Orbax ring and a ``weights:`` tower
  saved by orbax (the port's own Orbax reader).
* ``weights.llama`` quantized on load to int8 and int4: every leaf
  byte-identical to the JAX quantization; a partial load's ``loaded``,
  ``skipped`` and ``missing`` as the JAX report's; ``use_ve: False`` with
  ImageBind weights raises ``ValueError`` on both sides.

The JAX models' initialisers are traced (``TracedInitMyriad``), not
compiled, and every port model starts from the same initial tree.
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch

from myriad_tpu import checkpoint as jax_ckpt
from myriad_tpu.models.eva_vit import EvaViT as JaxEvaViT
from myriad_tpu.models.imagebind import ImageBindConfig as JaxIbConfig
from myriad_tpu.models.imagebind import ImageBindText as JaxIbText
from myriad_tpu.models.imagebind import ImageBindVision as JaxIbVision
from myriad_tpu.models.layers import Policy as JaxPolicy
from myriad_tpu.models.myriad import MyriadArch as JaxArch
from myriad_tpu.models.qformer import QFormer as JaxQFormer
from myriad_tpu.ops import quant as jax_quant
from myriad_tpu_torch.convert_from_jax import jax_path_of, state_dict_from_jax
from myriad_tpu_torch.models.eva_vit import EvaViT
from myriad_tpu_torch.models.imagebind import ImageBindConfig, ImageBindText, ImageBindVision
from myriad_tpu_torch.models.layers import Policy, QuantDense
from myriad_tpu_torch.models.myriad import Myriad
from myriad_tpu_torch.models.qformer import QFormer
from myriad_tpu_torch.ops import quant
from test_torch_myriad import SCENES, TracedInitMyriad, _perturb
import torch_threads  # noqa: F401  (one torch thread a test process)

TOL = dict(atol=1e-5, rtol=1e-5)
INT8_TOWERS = {"arch_preset": "tiny", "vit_weight_dtype": "int8",
               "qformer_weight_dtype": "int8", "ve_weight_dtype": "int8",
               "llm_weight_dtype": "int8", "llm_kv_dtype": "int8", "param_policy": "fp32",
               "end_sym": "###"}
GEN_KW = dict(max_new_tokens=10, cache_granularity=16, stop_single=5, stop_pair=(7, 9))
QUESTION = "<Img><ImageHere></Img>find out if there are defects in this image."
PATTERNS = {"vit": jax_quant.EVA_QUANT_PATTERN, "qformer": jax_quant.QFORMER_QUANT_PATTERN,
            "imagebind": jax_quant.IMAGEBIND_QUANT_PATTERN,
            "llama": jax_quant.LLAMA_QUANT_PATTERN}


def _np(x):
    return np.asarray(x, np.float32)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


@pytest.fixture(scope="module")
def towers():
    """Perturbed float towers of the tiny Myriad and its vision expert, as
    the converters write them: {tower: JAX-layout tree}."""
    jm = TracedInitMyriad(arch=JaxArch.tiny(), use_ve=True, policy=JaxPolicy.fp32())
    rng = np.random.default_rng(21)
    p = _perturb(jax.tree_util.tree_map(np.asarray, jm.params), rng, std=0.05)
    ve = _perturb(jax.tree_util.tree_map(np.asarray, jm.vision_expert.params["params"]), rng,
                  std=0.05)
    return {"vit": p["visual_encoder"],
            "qformer": {"qformer": p["qformer"], "query_tokens": p["query_tokens"],
                        "ln_vision": p["ln_vision"]},
            "llama": p["llama"], "llama_proj": {"llama_proj": p["llama_proj"]},
            "imagebind": {"visual": ve["visual"], "text": ve["text"]},
            "decoder": ve["image_decoder"]}


@pytest.fixture(scope="module")
def files(towers, tmp_path_factory):
    """The towers as npz files written by the JAX ``save_params``."""
    root = tmp_path_factory.mktemp("weights")
    paths = {}
    for key, tree in towers.items():
        paths[key] = str(root / f"{key}.npz")
        jax_ckpt.save_params(paths[key], tree)
    return paths


@pytest.mark.parametrize("tower,mode", [("vit", "int8"), ("qformer", "int8"),
                                        ("imagebind", "int8"), ("llama", "int8"),
                                        ("llama", "int4")])
def test_quantize_tree_matches_jax(towers, tower, mode):
    ref = _leaves(jax_quant.quantize_tree(towers[tower], PATTERNS[tower], mode))
    out = _leaves(quant.quantize_tree(towers[tower], PATTERNS[tower], mode))
    assert list(out) == list(ref)
    payload = "w_int4" if mode == "int4" else "w_int8"
    assert any(str(k[-1].key) == payload for k in out)
    for k, r in ref.items():
        o, r = np.asarray(out[k]), np.asarray(r)
        assert o.dtype == r.dtype and o.shape == r.shape, k
        if o.dtype.kind == "f":
            ulps = np.abs(o.view(np.int32).astype(np.int64) - r.view(np.int32))
            assert ulps.max() <= 1, k
        else:
            np.testing.assert_array_equal(o, r, err_msg=str(k))


def _int8_payloads_equal(module, jax_tree):
    sd = module.state_dict()
    n = 0
    for name, t in sd.items():
        if name.endswith("w_int8"):
            node = jax_tree
            for part in jax_path_of(module, name).split("/"):
                node = node[part]
            np.testing.assert_array_equal(t.numpy(), np.asarray(node), err_msg=name)
            n += 1
    assert n > 0


def _images(n=2, seed=1):
    return np.random.default_rng(seed).normal(size=(n, 28, 28, 3)).astype(np.float32)


def _tower_pair(build_port, tree, pattern):
    jtree = jax_quant.quantize_tree(tree, pattern)
    port = build_port()
    port.load_state_dict(state_dict_from_jax(quant.quantize_tree(tree, pattern)), strict=True)
    _int8_payloads_equal(port, jtree)
    return jtree, port


def test_int8_eva_vit_matches_jax(towers):
    a = JaxArch.tiny()
    kw = dict(img_size=a.img_size, patch_size=a.vit_patch, embed_dim=a.vit_dim,
              depth=a.vit_depth, num_heads=a.vit_heads, mlp_ratio=a.vit_mlp_ratio)
    jtree, port = _tower_pair(
        lambda: EvaViT(**kw, weight_dtype="int8", policy=Policy.fp32(), device="cpu"),
        towers["vit"], quant.EVA_QUANT_PATTERN)
    x = _images()
    ref = jax.jit(JaxEvaViT(**kw, weight_dtype="int8", dtype=np.float32,
                            param_dtype=np.float32).apply)({"params": jtree}, x)
    with torch.inference_mode():
        out = port(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)


def test_int8_qformer_matches_jax(towers):
    a = JaxArch.tiny()
    kw = dict(hidden_size=a.qformer_hidden, num_layers=a.qformer_layers,
              num_heads=a.qformer_heads, intermediate_size=a.qformer_intermediate)
    jtree, port = _tower_pair(
        lambda: QFormer(encoder_dim=a.vit_dim, weight_dtype="int8", **kw, policy=Policy.fp32(),
                        device="cpu"),
        towers["qformer"]["qformer"], quant.QFORMER_QUANT_PATTERN)
    r = np.random.default_rng(5)
    q = r.normal(size=(2, 11, a.qformer_hidden)).astype(np.float32)
    feats = r.normal(size=(2, 5, a.vit_dim)).astype(np.float32)
    ref = jax.jit(JaxQFormer(**kw, weight_dtype="int8", dtype=np.float32,
                             param_dtype=np.float32).apply)({"params": jtree}, q, feats)
    with torch.inference_mode():
        out = port(torch.from_numpy(q), torch.from_numpy(feats))
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)


def test_int8_imagebind_vision_matches_jax(towers):
    jtree, port = _tower_pair(
        lambda: ImageBindVision(ImageBindConfig.tiny(img_size=28, weight_dtype="int8"),
                                policy=Policy.fp32(), device="cpu"),
        towers["imagebind"]["visual"], quant.IMAGEBIND_QUANT_PATTERN)
    jcfg = JaxIbConfig.tiny(img_size=28, weight_dtype="int8")
    x = _images(seed=3)
    emb_ref, taps_ref = jax.jit(JaxIbVision(jcfg, dtype=np.float32,
                                            param_dtype=np.float32).apply)({"params": jtree}, x)
    with torch.inference_mode():
        emb, taps = port(torch.from_numpy(x))
    np.testing.assert_allclose(emb.numpy(), _np(emb_ref), **TOL)
    for t, tr in zip(taps, taps_ref, strict=True):
        np.testing.assert_allclose(t.numpy(), _np(tr), **TOL)


def test_int8_imagebind_text_matches_jax(towers):
    jtree, port = _tower_pair(
        lambda: ImageBindText(ImageBindConfig.tiny(img_size=28, weight_dtype="int8"),
                              policy=Policy.fp32(), device="cpu"),
        towers["imagebind"]["text"], quant.IMAGEBIND_QUANT_PATTERN)
    jcfg = JaxIbConfig.tiny(img_size=28, weight_dtype="int8")
    ids = np.random.default_rng(4).integers(1, 60, size=(3, 16))
    ids[:, 9] = 63  # the EOS: the largest id
    ref = jax.jit(JaxIbText(jcfg, dtype=np.float32, param_dtype=np.float32).apply)(
        {"params": jtree}, ids)
    with torch.inference_mode():
        out = port(torch.from_numpy(ids))
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)


class RecordingInit(TracedInitMyriad):
    """``TracedInitMyriad`` keeping its initial trees, from which every port
    model of a test starts."""

    def _init_params(self, rng):
        params = super()._init_params(rng)
        type(self).initial = jax.tree_util.tree_map(np.asarray, params)
        return params

    def _init_ve_params(self, ve_module, rng):
        params = super()._init_ve_params(ve_module, rng)
        type(self).initial_ve = jax.tree_util.tree_map(np.asarray, params["params"])
        return params


def _jax_model(cfg):
    jm = RecordingInit.from_config(dict(cfg))
    ve = jm.vision_expert
    if ve is not None:
        ve.class_names = SCENES
        ve.class_index = {c: i for i, c in enumerate(SCENES)}
        ve.build_text_features()
    return jm, RecordingInit.initial, RecordingInit.initial_ve


def _jax_copy(jm):
    """A copy of the JAX model ``jm`` (its initialisation, towers, compiled
    programs and text features) whose parameters a load replaces in the
    copy alone: the JAX from_config of a config that adds one load to
    ``jm``'s, once that load is applied."""
    v = copy.copy(jm)
    v.vision_expert = copy.copy(jm.vision_expert)
    v.expert = v.vision_expert  # the fused generate serves the model's own expert
    return v


def _port_model(cfg, initial, initial_ve):
    pm = Myriad.from_config(dict(cfg), device="cpu", class_names=SCENES)
    pm.load_state_dicts(state_dict_from_jax(initial),
                        state_dict_from_jax(initial_ve) if pm.vision_expert else None)
    return pm


def _samples():
    rng = np.random.default_rng(7)
    return {"image": rng.integers(0, 256, size=(2, 28, 28, 3), dtype=np.uint8),
            "scene": list(SCENES), "question2": [QUESTION] * 2}


def _same_params(jm, pm):
    ref = state_dict_from_jax(jm.params)
    sd = pm.module.state_dict()
    assert set(sd) == set(ref)
    for name, t in sd.items():
        np.testing.assert_array_equal(t.numpy(), ref[name].numpy(), err_msg=name)
    if jm.vision_expert is not None:
        ref = state_dict_from_jax(jm.vision_expert.params["params"])
        for name, t in pm.vision_expert.module.state_dict().items():
            np.testing.assert_array_equal(t.numpy(), ref[name].numpy(), err_msg=name)


def _same_generate(jm, pm):
    ref = jm.generate(_samples(), **GEN_KW)
    out = pm.generate(_samples(), **GEN_KW)
    np.testing.assert_array_equal(out["token_ids"].numpy(), np.asarray(ref["token_ids"]))
    np.testing.assert_allclose(out["ve_anomaly_maps"].numpy(), _np(ref["ve_anomaly_maps"]),
                               **TOL)
    return out


@pytest.fixture(scope="module")
def loaded(files):
    """The all-int8 tiny Myriad with every tower under ``weights:``, built by
    both ``from_config``s from the same initial tree."""
    cfg = dict(INT8_TOWERS, weights=dict(files))
    jm, initial, initial_ve = _jax_model(cfg)
    pm = _port_model(cfg, initial, initial_ve)
    return cfg, jm, pm, (initial, initial_ve)


def _report(r):
    return ({k: sorted(v) for k, v in r["loaded"].items()},
            {k: sorted(v) for k, v in r["skipped"].items()}, sorted(r["missing"]))


def test_weights_npz_int8_towers_generate_as_jax(loaded):
    """The harness's tower profile served from converted npz towers: the
    parameters after both loads are identical (int8 payloads, scales,
    biases), so are the reports (every frozen leaf covered), and generate
    gives the JAX tokens and maps."""
    cfg, jm, pm, _ = loaded
    assert (pm.arch.vit_weight_dtype, pm.arch.qformer_weight_dtype,
            pm.arch.imagebind.weight_dtype) == ("int8",) * 3
    assert isinstance(pm.module.qformer.layer[0].crossattention.key, QuantDense)
    _same_params(jm, pm)
    assert _report(pm.weights_report) == _report(_jax_report(jm, cfg["weights"]))
    assert pm.weights_report["missing"] == []
    out = _same_generate(jm, pm)
    assert int((out["token_ids"] > 0).sum()) > 0


def _jax_report(jm, weights):
    return _jax_copy(jm).load_pretrained_weights(dict(weights))


def test_weights_survive_init_random(loaded):
    """``init_random`` (what evaluate, the demo and training call after
    ``from_config``) keeps the loaded towers: the towers are loaded again
    over the seeded draw."""
    cfg, jm, _, _ = loaded
    pm = Myriad.from_config(dict(cfg), device="cpu", class_names=SCENES)
    pm.init_random(3)
    ref = state_dict_from_jax(jm.params)
    frozen = [n for n in pm.module.state_dict() if n not in pm.trainable_names]
    for name in frozen:
        np.testing.assert_array_equal(pm.module.state_dict()[name].numpy(), ref[name].numpy(),
                                      err_msg=name)
    assert pm.weights_report["missing"] == []


def test_partial_weights_report_as_jax(loaded, towers, tmp_path):
    """A vit tree without its last block and with an unknown leaf, a
    Q-Former tree without query_tokens, and the decoder: ``loaded``,
    ``skipped`` and ``missing`` equal the JAX report's."""
    cfg, jm, _, (initial, initial_ve) = loaded
    vit = dict(towers["vit"])
    vit.pop(f"blocks_{JaxArch.tiny().vit_depth - 1}")
    vit["unknown_leaf"] = np.zeros(3, np.float32)
    qformer = {k: v for k, v in towers["qformer"].items() if k != "query_tokens"}
    paths = {"vit": str(tmp_path / "vit.npz"), "qformer": str(tmp_path / "qformer.npz")}
    jax_ckpt.save_params(paths["vit"], vit)
    jax_ckpt.save_params(paths["qformer"], qformer)
    weights = dict(paths, decoder=towers["decoder"])
    ref = _jax_report(jm, weights)
    pm = _port_model({k: v for k, v in cfg.items() if k != "weights"}, initial, initial_ve)
    report = pm.load_pretrained_weights(weights)
    assert _report(report) == _report(ref)
    assert report["missing"] and report["skipped"]["vit"] == ["visual_encoder/unknown_leaf"]


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_weights_llama_quantized_on_load_as_jax(files, towers, mode):
    """``weights.llama`` under ``llm_weight_dtype`` int8 or int4: every LLaMA
    leaf after the load equals the JAX quantization of the float tree."""
    pm = Myriad.from_config({"arch_preset": "tiny", "llm_weight_dtype": mode,
                             "param_policy": "fp32", "use_ve": False,
                             "weights": {"llama": files["llama"]}}, device="cpu")
    pm.init_random(0)
    ref = state_dict_from_jax({"llama": jax_quant.quantize_tree(towers["llama"], mode=mode)})
    sd = pm.module.state_dict()
    payload = "w_int4" if mode == "int4" else "w_int8"
    assert any(n.endswith(payload) for n in ref)
    for name, t in ref.items():
        np.testing.assert_array_equal(sd[name].numpy(), t.numpy(), err_msg=name)
    assert pm.weights_report["missing"] == []


def _blip2_state_dict(arch, seed=3):
    """A raw BLIP-2 checkpoint's Q-Former entries ('Qformer.bert.*'), as
    tests/test_weights_loading.py writes one."""
    rng = np.random.default_rng(seed)

    def lin(i, o):
        return rng.normal(size=(o, i)).astype(np.float32) * 0.3

    h, inter, vit = arch.qformer_hidden, arch.qformer_intermediate, arch.vit_dim
    sd = {"query_tokens": rng.normal(size=(1, arch.num_query_token, h)).astype(np.float32),
          "ln_vision.weight": 1 + rng.normal(size=vit).astype(np.float32) * 0.1,
          "ln_vision.bias": rng.normal(size=vit).astype(np.float32) * 0.1,
          "Qformer.bert.embeddings.LayerNorm.weight": np.ones(h, np.float32),
          "Qformer.bert.embeddings.LayerNorm.bias": np.zeros(h, np.float32)}
    for i in range(arch.qformer_layers):
        pre = f"Qformer.bert.encoder.layer.{i}."
        atts = (("attention.", h),) + ((("crossattention.", vit),) if i % 2 == 0 else ())
        for att, kdim in atts:
            for name, ind in (("query", h), ("key", kdim), ("value", kdim)):
                sd[pre + att + f"self.{name}.weight"] = lin(ind, h)
                sd[pre + att + f"self.{name}.bias"] = rng.normal(size=h).astype(np.float32)
            sd[pre + att + "output.dense.weight"] = lin(h, h)
            sd[pre + att + "output.dense.bias"] = np.zeros(h, np.float32)
            sd[pre + att + "output.LayerNorm.weight"] = np.ones(h, np.float32)
            sd[pre + att + "output.LayerNorm.bias"] = np.zeros(h, np.float32)
        sd[pre + "intermediate_query.dense.weight"] = lin(h, inter)
        sd[pre + "intermediate_query.dense.bias"] = np.zeros(inter, np.float32)
        sd[pre + "output_query.dense.weight"] = lin(inter, h)
        sd[pre + "output_query.dense.bias"] = np.zeros(h, np.float32)
        sd[pre + "output_query.LayerNorm.weight"] = np.ones(h, np.float32)
        sd[pre + "output_query.LayerNorm.bias"] = np.zeros(h, np.float32)
    return sd


def test_blip2_pth_as_q_former_model_as_jax(loaded, tmp_path):
    """A local raw BLIP-2 ``.pth`` named by ``q_former_model`` folds into
    ``weights.qformer``, converts in place and quantizes: the same
    parameters and tokens as the JAX model's."""
    cfg, jm0, _, initial = loaded
    path = str(tmp_path / "blip2_pretrained.pth")
    torch.save({"model": {k: torch.from_numpy(v)
                          for k, v in _blip2_state_dict(JaxArch.tiny()).items()}}, path)
    weights = {k: v for k, v in cfg["weights"].items() if k != "qformer"}
    cfg = dict(cfg, weights=weights, q_former_model=path)
    # the JAX from_config folds the file into weights.qformer, which covers
    # every Q-Former leaf: the towers' load then this one
    jm = _jax_copy(jm0)
    jm.load_pretrained_weights({"qformer": path})
    pm = _port_model(cfg, *initial)
    assert pm.weights["qformer"] == path
    assert pm.weights_report["missing"] == []
    _same_params(jm, pm)
    _same_generate(jm, pm)


@pytest.mark.parametrize("ring", [False, True])
def test_npz_ckpt_as_jax(loaded, tmp_path, ring):
    """``ckpt:`` an npz trainable tree, bare or inside a runner ring's
    ``model`` (beside ``optimizer`` and ``epoch``): merged into the
    trainables after the towers, as the JAX ``load_checkpoint`` merges."""
    cfg, jm0, _, initial = loaded
    trainable = _perturb(jax.tree_util.tree_map(np.asarray, jm0.trainable),
                         np.random.default_rng(9), std=0.3)
    state = ({"model": trainable, "optimizer": {"count": np.asarray(4)},
              "epoch": np.asarray(2)} if ring else trainable)
    path = str(tmp_path / "checkpoint_2.npz")
    jax_ckpt.save_params(path, state)
    cfg = dict(cfg, ckpt=path)
    jm = _jax_copy(jm0)
    jm.load_checkpoint(path)
    pm = _port_model(cfg, *initial)
    ref = state_dict_from_jax(trainable)
    live = pm.trainable_state_dict()
    assert set(ref) == set(live)
    for name, t in ref.items():
        np.testing.assert_array_equal(live[name].detach().numpy(), t.numpy(), err_msg=name)
    _same_params(jm, pm)
    _same_generate(jm, pm)


def test_orbax_ckpt_and_weights_tower_as_jax(loaded, towers, tmp_path):
    """``ckpt:`` a runner ring the JAX ``CheckpointManager`` wrote (an Orbax
    directory: OCDBT, zstd chunks) and ``weights.llama_proj`` a tower saved
    by ``ocp.StandardCheckpointer``: both read by the port's own Orbax
    reader, the same parameters and tokens as the JAX model's loads of the
    same directories."""
    import orbax.checkpoint as ocp

    cfg, jm0, _, initial = loaded
    rng = np.random.default_rng(11)
    trainable = _perturb(jax.tree_util.tree_map(np.asarray, jm0.trainable), rng, std=0.3)
    ring = jax_ckpt.CheckpointManager(str(tmp_path / "ring")).save(
        2, {"model": trainable, "epoch": np.asarray(2), "global_step": np.asarray(12)})
    proj = str(tmp_path / "llama_proj")
    saver = ocp.StandardCheckpointer()
    saver.save(proj, _perturb(towers["llama_proj"], rng, std=0.05))
    saver.wait_until_finished()
    cfg = dict(cfg, weights=dict(cfg["weights"], llama_proj=proj), ckpt=ring)
    jm = _jax_copy(jm0)
    jm.load_pretrained_weights({"llama_proj": proj})
    jm.load_checkpoint(ring)
    pm = _port_model(cfg, *initial)
    assert pm.weights_report["loaded"]["llama_proj"]
    _same_params(jm, pm)
    _same_generate(jm, pm)


def test_use_ve_false_with_imagebind_weights_raises(files):
    cfg = {"arch_preset": "tiny", "param_policy": "fp32", "use_ve": False,
           "weights": {"imagebind": files["imagebind"]}}
    with pytest.raises(ValueError, match="use_ve"):
        TracedInitMyriad.from_config(dict(cfg))
    with pytest.raises(ValueError, match="use_ve"):
        Myriad.from_config(dict(cfg), device="cpu")


def test_jax_paths_of_the_port_modules(loaded):
    """``jax_path_of`` names every port tensor by its JAX path: the missing
    report's paths are the JAX model's."""
    _, jm, pm, _ = loaded
    paths = {jax_path_of(pm.module, n) for n in pm.module.state_dict()}
    assert paths == set(jax_ckpt.tree_paths(jm.params))
    ve = pm.vision_expert.module
    assert ({jax_path_of(ve, n) for n in ve.state_dict()}
            == set(jax_ckpt.tree_paths(jm.vision_expert.params["params"])))
    assert os.path.basename(pm.weights["vit"]) == "vit.npz"
