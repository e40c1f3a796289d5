"""The port's whole serving slice (myriad_tpu_torch/models/myriad.py) against
the JAX package's ``Myriad.generate``, and the port's package rules, on the CPU.

The slice runs zero-shot VE maps -> encode_img -> int8-weight, int8-KV tiny
Vicuna greedy decode at ``MyriadArch.tiny`` in fp32 with the same random
weights on both sides.  Gates: token ids identical; maps within 1e-5 (the
gate of tests/test_myriad_model.py).  The JAX side's variants (int4 weights,
a larger vocab, a bos embedding) are copies of the one JAX model with the
changed arch and parameters swapped in, so that none of them pays for a
second JAX initialisation.
"""

import ast
import copy
import dataclasses
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myriad_tpu import checkpoint as ckpt_lib
from myriad_tpu.models.layers import Policy as JaxPolicy
from myriad_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from myriad_tpu.models.myriad import Myriad as JaxMyriad
from myriad_tpu.models.myriad import MyriadArch as JaxArch
from myriad_tpu.models.myriad import MyriadModule as JaxMyriadModule
from myriad_tpu.ops.quant import quantize_tree
from myriad_tpu_torch.convert_from_jax import state_dict_from_jax
from myriad_tpu_torch.models.layers import Policy
from myriad_tpu_torch.models.llama import LlamaConfig
from myriad_tpu_torch.models.myriad import Myriad, MyriadArch
from test_torch_llama import _float_params, _init_like
import torch_threads  # noqa: F401  (one torch thread a test process)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUESTION = "<Img><ImageHere></Img>find out if there are defects in this image."
SCENES = ["bottle", "cable"]


def _perturb(tree, rng, std=0.2):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng, std)
        else:
            a = np.asarray(v)
            out[k] = a + rng.normal(size=a.shape).astype(a.dtype) * std if a.dtype.kind == "f" else a
    return out


class TracedInitMyriad(JaxMyriad):
    """The JAX Myriad with its two initialisers traced (``jax.eval_shape``)
    and filled by ``_init_like``, not compiled: the tests overwrite every
    parameter anyway, and each compiled init costs tens of seconds."""

    def _init_params(self, rng):
        return _init_like(jax.eval_shape(lambda r: JaxMyriad._init_params(self, r), rng),
                          np.random.default_rng(100))

    def _init_ve_params(self, ve_module, rng):
        return _init_like(
            jax.eval_shape(lambda r: JaxMyriad._init_ve_params(self, ve_module, r), rng),
            np.random.default_rng(101))


@pytest.fixture(scope="module")
def pair():
    """Tiny JAX Myriad (int8 LLM weights, int8 KV) with perturbed weights, and
    the port loaded from the same weights through the bridge."""
    jcfg = JaxLlamaConfig.tiny(weight_dtype="int8", kv_cache_dtype="int8")
    jm = TracedInitMyriad(arch=JaxArch.tiny(llama=jcfg), use_ve=True, policy=JaxPolicy.fp32(),
                          max_txt_len=16)
    rng = np.random.default_rng(0)
    params = _perturb(jax.tree_util.tree_map(np.asarray, jm.params), rng)
    # the int8 LLM leaves come from quantizing perturbed float weights (the
    # int8 model initialises its payloads to zeros)
    params["llama"] = quantize_tree(_float_params(1))
    jm.trainable, jm.frozen = ckpt_lib.split_by_predicate(params, jm._trainable_predicate())
    ve = jm.vision_expert
    ve.params = {"params": _perturb(jax.tree_util.tree_map(np.asarray, ve.params["params"]),
                                    rng)}
    ve.class_names = SCENES
    ve.class_index = {c: i for i, c in enumerate(SCENES)}
    ve.build_text_features()
    arch = MyriadArch.tiny(llama=LlamaConfig.tiny(weight_dtype="int8", kv_cache_dtype="int8"))
    pm = Myriad(arch, policy=Policy.fp32(), device="cpu", class_names=SCENES)
    pm.load_state_dicts(state_dict_from_jax(params), state_dict_from_jax(ve.params["params"]))
    return jm, pm


def _samples(n=2):
    rng = np.random.default_rng(7)
    return {"image": rng.integers(0, 256, size=(n, 28, 28, 3), dtype=np.uint8),
            "scene": ["bottle", "cable"][:n], "question2": [QUESTION] * n}


GEN_KW = dict(max_new_tokens=10, cache_granularity=16, stop_single=5, stop_pair=(7, 9))
TINY = {"arch_preset": "tiny", "llm_weight_dtype": "int8", "llm_kv_dtype": "int8",
        "param_policy": "fp32"}


@pytest.fixture(scope="module")
def jax_greedy(pair):
    """The JAX Myriad's tokens and maps at one prefill chunk, no staging:
    prefill chunks and staged decode are token-exact in the JAX package by
    construction (tests/test_generation_invariance.py pins it), so every
    port variant is held to this one JAX compile."""
    jm, _ = pair
    return jm.generate(_samples(), **GEN_KW)


def _jax_variant(jm, llama=None, params=None, **attrs):
    """A copy of the JAX Myriad with another LLaMA config and parameters (no
    re-initialisation) or other host attributes, and its own compile cache."""
    v = copy.copy(jm)
    v._jit_cache, v._prompt_cache = {}, {}
    if llama is not None:
        v.arch = dataclasses.replace(jm.arch, llama=llama)
        v.module = JaxMyriadModule(v.arch, dtype=jm.policy.compute_dtype,
                                   param_dtype=jm.policy.param_dtype)
    if params is not None:
        v.trainable, v.frozen = ckpt_lib.split_by_predicate(params, v._trainable_predicate())
    for name, value in attrs.items():
        setattr(v, name, value)
    return v


def _port(cfg, jax_params, ve_state):
    """The port built by ``from_config`` (no policy argument) and loaded,
    strictly, from a JAX parameter tree."""
    pm = Myriad.from_config(cfg, device="cpu", class_names=SCENES)
    pm.load_state_dicts(state_dict_from_jax(jax_params), ve_state)
    return pm


def _int8_to_float(tree):
    """int8 {w_int8, scale} leaves back to float {kernel} (their dequantization)."""
    if not isinstance(tree, dict):
        return tree
    if "w_int8" in tree:
        return {"kernel": np.asarray(tree["w_int8"], np.float32) * np.asarray(tree["scale"])}
    return {k: _int8_to_float(v) for k, v in tree.items()}


def test_from_config_spec_generate_matches_jax(pair):
    """``llm_spec_k`` routes generate to speculative decoding, under the
    reference's sampling kwargs too: tokens and spec_stats identical to the
    JAX Myriad's, tokens identical to plain greedy."""
    jm, pm = pair
    spec = Myriad.from_config({"arch_preset": "tiny", "llm_weight_dtype": "int8",
                               "llm_kv_dtype": "int8", "llm_spec_k": 3, "end_sym": "###"},
                              policy=Policy.fp32(), device="cpu", class_names=SCENES)
    assert (spec.spec_k, spec.end_sym) == (3, "###")
    spec.load_state_dicts(pm.module.state_dict(), pm.vision_expert.module.state_dict())
    kw = dict(max_new_tokens=10, stop_single=5, stop_pair=(7, 9), do_sample=True, top_p=0.01)
    jm.spec_k, jm.end_sym = 3, "###"
    try:
        ref = jm.generate(_samples(), **kw)
    finally:
        jm.spec_k, jm.end_sym = 0, "\n"
    out = spec.generate(_samples(), **kw)
    np.testing.assert_array_equal(out["token_ids"].numpy(), np.asarray(ref["token_ids"]))
    assert out["spec_stats"] == {n: int(v) for n, v in ref["spec_stats"].items()}
    assert out["spec_stats"]["rounds"] > 0
    greedy = pm.generate(_samples(), **kw)
    assert "spec_stats" not in greedy
    torch.testing.assert_close(out["token_ids"], greedy["token_ids"], rtol=0, atol=0)


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("chunks", [1, 3])
def test_generate_matches_jax(pair, jax_greedy, chunks, staged):
    _, pm = pair
    out = pm.generate(_samples(), prefill_chunks=chunks, staged_decode=staged, **GEN_KW)
    np.testing.assert_array_equal(out["token_ids"].numpy(),
                                  np.asarray(jax_greedy["token_ids"]))
    np.testing.assert_allclose(out["ve_anomaly_maps"].numpy(),
                               np.asarray(jax_greedy["ve_anomaly_maps"]), rtol=1e-5, atol=1e-5)


class _JaxResolved(JaxMyriad):
    """``JaxMyriad.from_config`` up to its constructor: what it resolves."""

    def __init__(self, arch=None, **kw):
        self.kw = dict(kw, arch=arch)


class _Resolved(Myriad):
    """``Myriad.from_config`` up to its constructor: what it resolves."""

    def __init__(self, arch, **kw):
        self.kw = dict(kw, arch=arch)


def _resolved(cfg):
    """(JAX, port) settings that decide what the model computes."""
    j = _JaxResolved.from_config(dict(cfg)).kw
    p = _Resolved.from_config(dict(cfg), device="cpu").kw
    ja, pa = j["arch"], p["arch"]
    jpol, ppol = j["policy"], p["policy"] or Policy.bf16_params()
    jax_side = (ja.img_size, ja.num_query_token, ja.llama.vocab_size, ja.llama.weight_dtype,
                ja.llama.kv_cache_dtype, bool(j["use_lora"]), j["bos_at_generate"],
                jnp.dtype(jpol.param_dtype).name, jnp.dtype(jpol.compute_dtype).name)
    port_side = (pa.img_size, pa.num_query_token, pa.llama.vocab_size, pa.llama.weight_dtype,
                 pa.llama.kv_cache_dtype, pa.llama.use_lora, p["bos_at_generate"],
                 str(ppol.param_dtype).split(".")[-1], str(ppol.compute_dtype).split(".")[-1])
    return jax_side, port_side


WIRED = {
    "low_resource": {"low_resource": True},
    "low_resource_under_llm_weight_dtype": {"low_resource": True, "llm_weight_dtype": "int4"},
    "kv_cache_dtype": {"kv_cache_dtype": "int8"},
    "image_size": {"image_size": 42},
    "num_query_token": {"arch_preset": "full", "num_query_token": 16},
    "num_query_token_tiny_ignored": {"arch_preset": "tiny", "num_query_token": 16},
    "llm_vocab_size": {"llm_vocab_size": 300},
    "bos_at_generate": {"bos_at_generate": True},
    "param_policy_bf16": {"param_policy": "bf16"},
    "param_policy_bf16_params": {"param_policy": "bf16_params"},
    "param_policy_fp32": {"param_policy": "fp32"},
    "vit_precision_fp32": {"vit_precision": "fp32"},
    "vit_precision_fp16": {"vit_precision": "fp16"},
    "use_lora": {"use_lora": True},
    "dead_knobs": {"noise_level": 0.15, "use_ref": True, "vit_model": "eva_clip_g"},
}


@pytest.mark.parametrize("case", sorted(WIRED))
def test_from_config_resolves_keys_as_jax(case):
    """Every key the JAX ``from_config`` reads and the port serves resolves to
    the same arch, LLaMA config, bos rule and dtype policy on both sides (the
    port's policy when the config names none is its serving bf16 storage,
    where JAX's is fp32 storage: the same bf16 compute)."""
    cfg = {"arch_preset": "tiny", **WIRED[case]}
    jax_side, port_side = _resolved(cfg)
    if not any(k in cfg for k in ("param_policy", "vit_precision")):
        jax_side, port_side = jax_side[:-2], port_side[:-2]
    assert port_side == jax_side


@pytest.mark.parametrize("case,cfg", [
    ("low_resource", {"low_resource": True, "llm_kv_dtype": "int8", "param_policy": "fp32"}),
    ("kv_cache_dtype", {"llm_weight_dtype": "int8", "kv_cache_dtype": "int8",
                        "param_policy": "fp32"}),
    ("param_policy", {"llm_weight_dtype": "int8", "llm_kv_dtype": "int8",
                      "param_policy": "fp32"}),
    ("vit_precision", {"llm_weight_dtype": "int8", "llm_kv_dtype": "int8",
                       "vit_precision": "fp32"}),
])
def test_from_config_key_generates_as_jax(pair, jax_greedy, case, cfg):
    """Each wired key, built by ``from_config`` with no policy argument, gives
    the JAX model's tokens: these resolve to the JAX pair's own settings (int8
    weights, int8 KV, fp32), so its one compile is the reference.  A key
    dropped would change the weights' layout (the strict load fails) or the
    numerics (bf16 storage, a bf16 cache)."""
    jm, pm = pair
    out = _port({"arch_preset": "tiny", **cfg}, jm.params,
                pm.vision_expert.module.state_dict()).generate(_samples(), **GEN_KW)
    np.testing.assert_array_equal(out["token_ids"].numpy(), np.asarray(jax_greedy["token_ids"]))


def test_from_config_bos_at_generate_as_jax(pair):
    jm, pm = pair
    ref = _jax_variant(jm, bos_at_generate=True).generate(_samples(), **GEN_KW)
    port = _port({**TINY, "bos_at_generate": True}, jm.params,
                 pm.vision_expert.module.state_dict())
    assert port.bos_at_generate
    out = port.generate(_samples(), **GEN_KW)
    np.testing.assert_array_equal(out["token_ids"].numpy(), np.asarray(ref["token_ids"]))


def test_from_config_llm_vocab_size_as_jax(pair):
    """A 300-token vocab (the byte tokenizer's ids reach 258): the embedding
    and the head grow on both sides, the extra rows drawn from a seed."""
    jm, pm = pair
    rng = np.random.default_rng(11)
    params = jax.tree_util.tree_map(np.asarray, jm.params)
    emb = params["llama"]["model"]["embed_tokens"]["embedding"]
    head = params["llama"]["lm_head"]
    params["llama"]["model"]["embed_tokens"]["embedding"] = np.concatenate(
        [emb, rng.normal(size=(300 - emb.shape[0], emb.shape[1])).astype(np.float32)])
    params["llama"]["lm_head"] = np.concatenate(
        [head, rng.normal(size=(head.shape[0], 300 - head.shape[1])).astype(np.float32)], axis=1)
    variant = _jax_variant(jm, llama=dataclasses.replace(jm.arch.llama, vocab_size=300),
                           params=params)
    ref = variant.generate(_samples(), **GEN_KW)
    port = _port({**TINY, "llm_vocab_size": 300}, params, pm.vision_expert.module.state_dict())
    assert port.arch.llama.vocab_size == 300
    out = port.generate(_samples(), **GEN_KW)
    np.testing.assert_array_equal(out["token_ids"].numpy(), np.asarray(ref["token_ids"]))
    assert int(np.asarray(ref["token_ids"]).max()) < 300


@pytest.mark.parametrize("cfg", [{"qformer_weight_dtype": "int8"}, {"vit_weight_dtype": "int8"},
                                 {"ve_weight_dtype": "int8"},
                                 # what the JAX from_config would load (F8)
                                 {"weights": {"vit": "eva_vit_g.npz"}},
                                 {"ckpt": "output/myriad/checkpoint_4.pth"},
                                 {"q_former_model": os.path.abspath(__file__)},
                                 {"llama_model": os.path.dirname(os.path.abspath(__file__))}])
def test_from_config_unserved_keys_raise(cfg):
    """Keys the port does not serve raise, naming the key and the value
    (``use_ve`` and ``k_shot`` are served: tests/test_torch_vision_experts.py)."""
    (key, value), = cfg.items()
    with pytest.raises(NotImplementedError, match=re.escape(f"{key}={value!r}")):
        Myriad.from_config({"arch_preset": "tiny", **cfg}, device="cpu")


def test_from_config_builds_the_eval_config():
    """What the JAX from_config would not load builds: eval_configs/myriad.yaml's
    empty ckpt and llama_model, a q_former_model that is no local file (the
    JAX one warns) and a llama_model path that does not exist (the JAX one
    falls back to its byte tokenizer)."""
    import yaml

    with open(os.path.join(REPO, "eval_configs", "myriad.yaml")) as f:
        cfg = dict(yaml.safe_load(f)["model"], arch_preset="tiny", llama_model="",
                   q_former_model="https://example.invalid/blip2.pth")
    assert cfg["ckpt"] == ""
    Myriad.from_config(cfg, device="cpu", class_names=SCENES)
    Myriad.from_config({"arch_preset": "tiny", "llama_model": "/nonexistent/vicuna"},
                       device="cpu", class_names=SCENES)


def test_from_config_int4_generate_and_spec_match_jax(pair):
    """``llm_weight_dtype: int4``: tokens, and K = 2 tokens and spec_stats,
    identical to the JAX Myriad's.  The int4 leaves quantize the pair's
    dequantized int8 weights (``quantize_tree(mode="int4")``), so no
    projection is zero on either side."""
    jm, pm = pair
    params = jax.tree_util.tree_map(np.asarray, jm.params)
    params["llama"] = quantize_tree(_int8_to_float(params["llama"]), mode="int4")
    llama4 = dataclasses.replace(jm.arch.llama, weight_dtype="int4")
    ve_state = pm.vision_expert.module.state_dict()
    kw = dict(GEN_KW, prefill_chunks=1)
    for spec_k in (0, 2):
        ref = _jax_variant(jm, llama=llama4, params=params, spec_k=spec_k).generate(
            _samples(), **kw)
        port = _port({**TINY, "llm_weight_dtype": "int4", "llm_spec_k": spec_k}, params,
                     ve_state)
        out = port.generate(_samples(), **kw)
        np.testing.assert_array_equal(out["token_ids"].numpy(), np.asarray(ref["token_ids"]),
                                      err_msg=f"spec_k={spec_k}")
        if spec_k:
            assert out["spec_stats"] == {n: int(v) for n, v in ref["spec_stats"].items()}
            assert out["spec_stats"]["rounds"] > 0


def test_reference_sampling_kwargs_route_to_greedy(pair):
    _, pm = pair
    greedy = pm.generate(_samples(), max_new_tokens=4)["token_ids"]
    shipped = pm.generate(_samples(), max_new_tokens=4, do_sample=True, top_p=0.01,
                          temperature=1.0)["token_ids"]
    torch.testing.assert_close(shipped, greedy, rtol=0, atol=0)
    with pytest.raises(NotImplementedError):
        pm.generate(_samples(), max_new_tokens=4, do_sample=True, top_p=0.9)


def test_split_prompt_matches_jax(pair):
    jm, pm = pair
    for a, b in zip(pm.split_prompt(QUESTION), jm.split_prompt(QUESTION)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_bridge_loads_strictly_both_ways(pair):
    jm, pm = pair
    sd = state_dict_from_jax(jm.params)
    assert set(sd) == set(pm.module.state_dict())
    missing = dict(sd)
    missing.pop(next(iter(missing)))
    with pytest.raises(RuntimeError, match="Missing key"):
        pm.module.load_state_dict(missing, strict=True)
    extra = dict(sd, **{"llama.unused": torch.zeros(1)})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        pm.module.load_state_dict(extra, strict=True)
    pm.module.load_state_dict(sd, strict=True)
    # layouts: Dense (in, out) -> (out, in); int8 stays (in, out)
    q = jm.params["llama"]["model"]["layers_0"]["self_attn"]["q_proj"]["base"]
    np.testing.assert_array_equal(sd["llama.model.layers.0.self_attn.q_proj.base.w_int8"],
                                  np.asarray(q["w_int8"]))
    np.testing.assert_array_equal(sd["llama_proj.weight"].numpy(),
                                  np.asarray(jm.params["llama_proj"]["kernel"]).T)


def test_copied_constants_equal_the_originals():
    import yaml

    from myriad_tpu.datasets import anomaly_detection as jad
    from myriad_tpu.datasets.anomaly_detection import QUESTION_PROMPTS
    from myriad_tpu.models import vision_expert as jve
    from myriad_tpu.processors.functional import CLIP_MEAN, CLIP_STD
    from myriad_tpu_torch.models import myriad as tmyriad
    from myriad_tpu_torch.models import vision_expert as tve
    from myriad_tpu_torch.ops import preprocess

    for name in ("PROMPT_NORMAL", "PROMPT_ABNORMAL", "PROMPT_TEMPLATES",
                 "MVTEC_CLASS_NAMES", "VISA_CLASS_NAMES"):
        assert getattr(tve, name) == getattr(jve, name), name
    assert tve.prompt_sentences_for("metal_nut") == jve.prompt_sentences_for("metal_nut")
    np.testing.assert_array_equal(np.float32(preprocess.CLIP_MEAN), CLIP_MEAN)
    np.testing.assert_array_equal(np.float32(preprocess.CLIP_STD), CLIP_STD)
    sys.path.insert(0, REPO)
    import chip_smoke

    assert chip_smoke.AQA_QUESTION == "<Img><ImageHere></Img>" + QUESTION_PROMPTS[1]
    for name in ("NORMAL_DESCRIBE", "ABNORMAL_DESCRIBE"):
        assert getattr(tmyriad, name) == getattr(jad, name), name
    with open(os.path.join(REPO, "eval_configs", "myriad.yaml")) as f:
        eval_cfg = yaml.safe_load(f)["model"]
    assert chip_smoke.SERVING["end_sym"] == eval_cfg["end_sym"] == "###"


def test_byte_tokenizer_copy_is_the_jax_one():
    from myriad_tpu.tokenization import ByteTokenizer as JaxByteTokenizer
    from myriad_tpu_torch.tokenization import ByteTokenizer

    ours, theirs = ByteTokenizer(), JaxByteTokenizer()
    texts = ["###Human: <Img>", "défaut à gauche ###", "naïve 漢字 ✓", ""]
    for s in texts:
        for special in (False, True):
            assert ours.encode(s, special) == theirs.encode(s, special)
            assert ours(s, add_special_tokens=special) == theirs(s, add_special_tokens=special)
        assert ours.decode(ours.encode(s)) == theirs.decode(theirs.encode(s)) == s
    rows = [[0, 1, 2, 38, 38, 38, 3], [200, 2, 1], [262, 300]]  # ids < 3 and past 258
    assert ours.batch_decode(rows) == theirs.batch_decode(rows)
    assert ours(texts, max_length=4) == theirs(texts, max_length=4)
    for name in ("vocab_size", "bos_token_id", "eos_token_id", "pad_token_id"):
        assert getattr(ours, name) == getattr(theirs, name), name


def test_hash_tokenizer_is_the_jax_one():
    from myriad_tpu.models.clip_tokenizer import HashTokenizer as JaxHashTokenizer
    from myriad_tpu_torch.models.clip_tokenizer import HashTokenizer

    long = " ".join(["flawless"] * 90)  # truncated to 77 with eot last
    for s in ("a photo of a damaged bottle.", "flawless metal nut", "défaut ###", "", long):
        for vocab in (49408, 1000):
            assert HashTokenizer(vocab).encode(s, 77) == JaxHashTokenizer(vocab).encode(s, 77)
            ids = JaxHashTokenizer(vocab).encode(s, 77)
            assert HashTokenizer(vocab).decode(ids) == JaxHashTokenizer(vocab).decode(ids)


def test_full_arch_prefix_is_297_positions():
    """The AQA prefix at full width: prompt bytes + 32 queries + 49 instructor
    tokens (through llama_proj) + 18 VETokenizer tokens, no bos."""
    from myriad_tpu.tokenization import ByteTokenizer

    sys.path.insert(0, REPO)
    import chip_smoke

    before, after = ("###Human: " + chip_smoke.AQA_QUESTION + " ###Assistant: ").split(
        "<ImageHere>")
    tok = ByteTokenizer()
    a = MyriadArch.full()
    assert len(tok.encode(before)) + a.num_query_token + 49 + 18 + len(tok.encode(after)) == 297


def test_from_config_serving_knobs():
    pm = Myriad.from_config({"arch_preset": "tiny", "llm_weight_dtype": "int8",
                             "llm_kv_dtype": "int8", "llm_prefill_chunks": 3,
                             "llm_cache_granularity": 16},
                            policy=Policy.fp32(), device="cpu", class_names=SCENES)
    assert pm.arch.llama.weight_dtype == "int8" and pm.arch.llama.kv_cache_dtype == "int8"
    assert (pm.prefill_chunks, pm.staged_decode, pm.cache_granularity) == (3, True, 16)
    int4 = Myriad.from_config({"arch_preset": "tiny", "llm_weight_dtype": "int4"},
                              policy=Policy.fp32(), device="cpu")
    assert int4.arch.llama.weight_dtype == "int4"
    assert "llama.model.layers.0.mlp.up_proj.w_int4" in int4.module.state_dict()
    shot = Myriad.from_config({"arch_preset": "tiny", "k_shot": 1, "round_index": 3},
                              policy=Policy.fp32(), device="cpu")
    assert (shot.k_shot, shot.round_index) == (1, 3)


def test_random_init_is_seeded_and_full():
    a = Myriad(MyriadArch.tiny(llama=LlamaConfig.tiny(weight_dtype="int8")),
               policy=Policy.fp32(), device="cpu", class_names=SCENES)
    b = Myriad(MyriadArch.tiny(llama=LlamaConfig.tiny(weight_dtype="int8")),
               policy=Policy.fp32(), device="cpu", class_names=SCENES)
    a.init_random(3)
    b.init_random(3)
    for (name, x), y in zip(a.module.state_dict().items(), b.module.state_dict().values()):
        assert torch.equal(x, y), name
        assert bool(torch.isfinite(x.float()).all()), name
    w8 = a.module.llama.model.layers[0].mlp.up_proj.w_int8
    assert w8.dtype == torch.int8 and int(w8.abs().max()) == 127  # per-column quant


def test_import_leaves_jax_out():
    """The port imports no JAX, flax, nor the host libraries the card lacks,
    and no module of the JAX package, through every entry point and a tiny
    (speculative) generate."""
    code = ("import sys, numpy as np, myriad_tpu_torch, myriad_tpu_torch.generation, "
            "myriad_tpu_torch.convert_from_jax, myriad_tpu_torch.models.myriad, "
            "myriad_tpu_torch.ops.quant, myriad_tpu_torch.ops.attention, "
            "myriad_tpu_torch.ops.decode_attention, myriad_tpu_torch.ops.prefill_attention, "
            "myriad_tpu_torch.ops.kv_write, myriad_tpu_torch.ops.preprocess, "
            "myriad_tpu_torch.tools.bwprobe, myriad_tpu_torch.conversation, "
            "myriad_tpu_torch.demo, myriad_tpu_torch.evaluate, "
            "myriad_tpu_torch.common.config, myriad_tpu_torch.common.yaml_subset, "
            "myriad_tpu_torch.datasets.png, myriad_tpu_torch.datasets.anomaly_detection, "
            "myriad_tpu_torch.datasets.loaders, myriad_tpu_torch.processors.functional, "
            "myriad_tpu_torch.serving, myriad_tpu_torch.serving.myriad_adapter, "
            "myriad_tpu_torch.train, myriad_tpu_torch.checkpoint, myriad_tpu_torch.tasks, "
            "myriad_tpu_torch.runners, myriad_tpu_torch.common.optim, "
            "myriad_tpu_torch.datasets.nsa, myriad_tpu_torch.datasets.builders, "
            "myriad_tpu_torch.models.vision_experts, myriad_tpu_torch.models.simplenet, "
            "myriad_tpu_torch.models.clip_tokenizer\n"
            "from myriad_tpu_torch.models.myriad import Myriad\n"
            "m = Myriad.from_config({'arch_preset': 'tiny', 'llm_weight_dtype': 'int8', "
            "'llm_kv_dtype': 'int8', 'llm_spec_k': 2}, device='cpu', class_names=['bottle'])\n"
            "m.init_random(0)\n"
            "img = np.zeros((1, 28, 28, 3), np.uint8)\n"
            "out = m.generate({'image': img, 'scene': ['bottle'], "
            "'question': '<Img><ImageHere></Img>Any defect?'}, max_new_tokens=3)\n"
            "assert out['token_ids'].shape == (1, 3) and 'spec_stats' in out\n"
            # the eval entry point over a two-image tree written by the port
            "import json, os, tempfile\n"
            "from myriad_tpu_torch.datasets.png import encode_png\n"
            "root = tempfile.mkdtemp()\n"
            "os.makedirs(os.path.join(root, 'mvtec', 'bottle', 'test', 'good'))\n"
            "with open(os.path.join(root, 'DC_MVTEC_test_normal.jsonl'), 'w') as f:\n"
            "    for i in range(2):\n"
            "        rel = f'mvtec/bottle/test/good/{i}.png'\n"
            "        with open(os.path.join(root, rel), 'wb') as g:\n"
            "            g.write(encode_png(np.full((30, 40, 3), 9 * i, np.uint8)))\n"
            "        f.write(json.dumps({'img_path': rel, 'is_anomaly': '0'}) + '\\n')\n"
            "cfg = os.path.join(root, 'cfg.yaml')\n"
            "with open(cfg, 'w') as f:\n"
            "    f.write('model:\\n  arch: myriad\\n  arch_preset: tiny\\n  image_size: 28\\n'\n"
            "            'datasets:\\n  anomaly_detection:\\n    img_size: 28\\n'\n"
            "            '    crop_size: 28\\n    build_info:\\n      storage: ' + root +\n"
            "            '\\nrun:\\n  device: cpu\\n')\n"
            "from myriad_tpu_torch import evaluate\n"
            "res = evaluate.main(['--cfg-path', cfg, '--bs', '2', '--max_new_tokens', '3', "
            "'--save_path', os.path.join(root, 'rows.jsonl')])\n"
            "assert len(res['rows']) == 2\n"
            "bad = [n for n in ('jax', 'flax', 'yaml', 'PIL', 'cv2', 'transformers') "
            "if n in sys.modules]\n"
            "bad += [n for n in sys.modules if n == 'myriad_tpu' or n.startswith('myriad_tpu.')]\n"
            "print('BAD', bad)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


# calls whose string arguments would name a file or module to read or load
_PATH_CALLS = {"open", "Path", "PurePath", "join", "exists", "isfile", "isdir", "listdir",
               "glob", "rglob", "read_text", "read_bytes", "load", "fromfile",
               "spec_from_file_location", "import_module", "__import__", "exec", "run",
               "Popen", "check_output"}


def _reaches_jax_package(text) -> bool:
    return isinstance(text, str) and (text == "myriad_tpu" or text.startswith("myriad_tpu/")
                                      or text.startswith("myriad_tpu."))


def _call_name(func) -> str:
    return func.id if isinstance(func, ast.Name) else getattr(func, "attr", "")


def test_port_sources_reach_nothing_of_the_jax_package():
    """Static check of every .py under myriad_tpu_torch/ and chip_smoke.py: no
    import of ``myriad_tpu`` or its modules, no dynamic import machinery, and
    no path into ``myriad_tpu/`` handed to a call that reads or loads."""
    files = sorted(Path(REPO, "myriad_tpu_torch").rglob("*.py")) + [Path(REPO, "chip_smoke.py")]
    assert len(files) > 20
    # every subpackage is walked, tools/ included
    assert Path(REPO, "myriad_tpu_torch", "tools", "bwprobe.py") in files
    assert Path(REPO, "myriad_tpu_torch", "serving", "engine.py") in files
    found = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            where = f"{path.relative_to(REPO)}:{getattr(node, 'lineno', 0)}"
            if isinstance(node, ast.Import):
                found += [where for a in node.names if _reaches_jax_package(a.name)]
            elif isinstance(node, ast.ImportFrom):
                if _reaches_jax_package(node.module or "") or node.module == "importlib":
                    found.append(where)
            elif isinstance(node, ast.Call) and _call_name(node.func) in _PATH_CALLS:
                args = node.args + [kw.value for kw in node.keywords]
                if any(_reaches_jax_package(c.value) for a in args for c in ast.walk(a)
                       if isinstance(c, ast.Constant)):
                    found.append(where)
            elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
                if any(_reaches_jax_package(getattr(side, "value", None))
                       for side in (node.left, node.right)):
                    found.append(where)
            elif isinstance(node, ast.Constant) and node.value == "myriad_tpu":
                found.append(where)
            if isinstance(node, ast.Import) and any(a.name == "importlib" for a in node.names):
                found.append(where)
    assert not found, found


def test_entry_points_default_to_the_card():
    """Built with no device, the port goes to CUDA; without a card that raises
    (torch's own error) and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: building there would succeed")
    with pytest.raises((RuntimeError, AssertionError)):
        Myriad(MyriadArch.tiny())
    with pytest.raises((RuntimeError, AssertionError)):
        Myriad.from_config({"arch_preset": "tiny"})


def test_chip_smoke_fails_without_a_card(tmp_path):
    res = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    res = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
