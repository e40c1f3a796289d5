"""The port's whole serving slice (myriad_tpu_torch/models/myriad.py) against
the JAX package's ``Myriad.generate``, and the port's package rules, on the CPU.

The slice runs zero-shot VE maps -> encode_img -> int8-weight, int8-KV tiny
Vicuna greedy decode at ``MyriadArch.tiny`` in fp32 with the same random
weights on both sides.  Gates: token ids identical; maps within 1e-5 (the
gate of tests/test_myriad_model.py).
"""

import ast
import os
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
    pm = Myriad(arch, policy=Policy.fp32(), device="cpu", class_names=SCENES)
    pm.load_state_dicts(state_dict_from_jax(params), state_dict_from_jax(ve.params["params"]))
    return jm, pm


def _samples(n=2):
    rng = np.random.default_rng(7)
    return {"image": rng.integers(0, 256, size=(n, 28, 28, 3), dtype=np.uint8),
            "scene": ["bottle", "cable"][:n], "question2": [QUESTION] * n}


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
    for unported in ({"llm_weight_dtype": "int4"}, {"k_shot": 1}):
        with pytest.raises(NotImplementedError):
            Myriad.from_config({"arch_preset": "tiny", **unported}, policy=Policy.fp32(),
                               device="cpu")


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
            "myriad_tpu_torch.ops.kv_write, myriad_tpu_torch.conversation, "
            "myriad_tpu_torch.demo\n"
            "from myriad_tpu_torch.models.myriad import Myriad\n"
            "m = Myriad.from_config({'arch_preset': 'tiny', 'llm_weight_dtype': 'int8', "
            "'llm_kv_dtype': 'int8', 'llm_spec_k': 2}, device='cpu', class_names=['bottle'])\n"
            "m.init_random(0)\n"
            "img = np.zeros((1, 28, 28, 3), np.uint8)\n"
            "out = m.generate({'image': img, 'scene': ['bottle'], "
            "'question': '<Img><ImageHere></Img>Any defect?'}, max_new_tokens=3)\n"
            "assert out['token_ids'].shape == (1, 3) and 'spec_stats' in out\n"
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
