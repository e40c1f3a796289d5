"""The port's whole serving slice (myriad_tpu_torch/models/myriad.py) against
the JAX package's ``Myriad.generate``, and the port's package rules, on the CPU.

The slice runs zero-shot VE maps -> encode_img -> int8-weight, int8-KV tiny
Vicuna greedy decode at ``MyriadArch.tiny`` in fp32 with the same random
weights on both sides.  Gates: token ids identical; maps within 1e-5 (the
gate of tests/test_myriad_model.py).
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myriad_tpu import checkpoint as ckpt_lib
from myriad_tpu.models.layers import Policy as JaxPolicy
from myriad_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from myriad_tpu.models.llama import LlamaForCausalLM as JaxLlama
from myriad_tpu.models.myriad import Myriad as JaxMyriad
from myriad_tpu.models.myriad import MyriadArch as JaxArch
from myriad_tpu.ops.quant import quantize_tree
from myriad_tpu_torch.convert_from_jax import state_dict_from_jax
from myriad_tpu_torch.models.layers import Policy
from myriad_tpu_torch.models.llama import LlamaConfig
from myriad_tpu_torch.models.myriad import Myriad, MyriadArch

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


@pytest.fixture(scope="module")
def pair():
    """Tiny JAX Myriad (int8 LLM weights, int8 KV) with perturbed weights, and
    the port loaded from the same weights through the bridge."""
    jcfg = JaxLlamaConfig.tiny(weight_dtype="int8", kv_cache_dtype="int8")
    jm = JaxMyriad(arch=JaxArch.tiny(llama=jcfg), use_ve=True, policy=JaxPolicy.fp32(),
                   max_txt_len=16)
    rng = np.random.default_rng(0)
    params = _perturb(jax.tree_util.tree_map(np.asarray, jm.params), rng)
    # the int8 LLM leaves come from quantizing perturbed float weights (the
    # int8 model initialises its payloads to zeros)
    flat = JaxLlama(JaxLlamaConfig.tiny(), jnp.float32, jnp.float32).init_params(
        jax.random.PRNGKey(1))["params"]
    params["llama"] = quantize_tree(_perturb(jax.tree_util.tree_map(np.asarray, flat), rng))
    jm.trainable, jm.frozen = ckpt_lib.split_by_predicate(params, jm._trainable_predicate())
    ve = jm.vision_expert
    ve.params = {"params": _perturb(jax.tree_util.tree_map(np.asarray, ve.params["params"]),
                                    rng)}
    ve.class_names = SCENES
    ve.class_index = {c: i for i, c in enumerate(SCENES)}
    ve.build_text_features()
    arch = MyriadArch.tiny(llama=LlamaConfig.tiny(weight_dtype="int8", kv_cache_dtype="int8"))
    pm = Myriad(arch, policy=Policy.fp32(), class_names=SCENES)
    pm.load_state_dicts(state_dict_from_jax(params), state_dict_from_jax(ve.params["params"]))
    return jm, pm


def _samples(n=2):
    rng = np.random.default_rng(7)
    return {"image": rng.integers(0, 256, size=(n, 28, 28, 3), dtype=np.uint8),
            "scene": ["bottle", "cable"][:n], "question2": [QUESTION] * n}


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("chunks", [1, 3])
def test_generate_matches_jax(pair, chunks, staged):
    jm, pm = pair
    kw = dict(max_new_tokens=10, prefill_chunks=chunks, staged_decode=staged,
              cache_granularity=16, stop_single=5, stop_pair=(7, 9))
    ref = jm.generate(_samples(), **kw)
    out = pm.generate(_samples(), **kw)
    np.testing.assert_array_equal(out["token_ids"].numpy(), np.asarray(ref["token_ids"]))
    np.testing.assert_allclose(out["ve_anomaly_maps"].numpy(),
                               np.asarray(ref["ve_anomaly_maps"]), rtol=1e-5, atol=1e-5)


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
    from myriad_tpu.datasets.anomaly_detection import QUESTION_PROMPTS
    from myriad_tpu.models import vision_expert as jve
    from myriad_tpu.processors.functional import CLIP_MEAN, CLIP_STD
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


def test_hash_tokenizer_is_the_jax_one():
    from myriad_tpu.models.clip_tokenizer import HashTokenizer
    from myriad_tpu_torch.models.vision_expert import hash_tokenizer

    for s in ("a photo of a damaged bottle.", "flawless metal nut"):
        assert hash_tokenizer(49408).encode(s, 77) == HashTokenizer(49408).encode(s, 77)


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
                            policy=Policy.fp32(), class_names=SCENES)
    assert pm.arch.llama.weight_dtype == "int8" and pm.arch.llama.kv_cache_dtype == "int8"
    assert (pm.prefill_chunks, pm.staged_decode, pm.cache_granularity) == (3, True, 16)
    for unported in ({"llm_weight_dtype": "int4"}, {"k_shot": 1}):
        with pytest.raises(NotImplementedError):
            Myriad.from_config({"arch_preset": "tiny", **unported}, policy=Policy.fp32())


def test_random_init_is_seeded_and_full():
    a = Myriad(MyriadArch.tiny(llama=LlamaConfig.tiny(weight_dtype="int8")),
               policy=Policy.fp32(), class_names=SCENES)
    b = Myriad(MyriadArch.tiny(llama=LlamaConfig.tiny(weight_dtype="int8")),
               policy=Policy.fp32(), class_names=SCENES)
    a.init_random(3)
    b.init_random(3)
    for (name, x), y in zip(a.module.state_dict().items(), b.module.state_dict().values()):
        assert torch.equal(x, y), name
        assert bool(torch.isfinite(x.float()).all()), name
    w8 = a.module.llama.model.layers[0].mlp.up_proj.w_int8
    assert w8.dtype == torch.int8 and int(w8.abs().max()) == 127  # per-column quant


def test_import_leaves_jax_out():
    """The port imports no JAX, flax, nor the host libraries the card lacks."""
    code = ("import sys, myriad_tpu_torch, myriad_tpu_torch.generation, "
            "myriad_tpu_torch.convert_from_jax, myriad_tpu_torch.models.myriad, "
            "myriad_tpu_torch.ops.quant, myriad_tpu_torch.ops.attention, "
            "myriad_tpu_torch.ops.decode_attention, myriad_tpu_torch.ops.prefill_attention\n"
            "from myriad_tpu_torch.models.myriad import Myriad, MyriadArch\n"
            "m = Myriad(MyriadArch.tiny(), class_names=['bottle'])\n"
            "bad = [n for n in ('jax', 'flax', 'yaml', 'PIL', 'cv2', 'transformers') "
            "if n in sys.modules]\n"
            "print('BAD', bad)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


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
