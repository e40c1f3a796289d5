"""The port's tensor-parallel serving (myriad_tpu_torch/parallel/, the sharded
LLaMA, ``ServingEngine(mesh=)``, ``Myriad.shard``) against the JAX package's
``model`` mesh axis, on the CPU.

The JAX side shards under GSPMD on the suite's 8-device CPU mesh
(``make_mesh(n_model=2)``, ``tree_shardings`` with the JAX rules), as
tests/test_serving_sharded.py and tests/test_parallel_training.py do.  The
port's side is two gloo ranks (tests/torch_tp_worker.py, port and torch
only), started once for every case, each holding its shard.  Gates: the
rule tables pattern for pattern; every rank's shard bit-equal to the JAX
array's shard on its model index, with the same fallback list; token ids
equal to the JAX sharded runs (tolerance 0), an int4 LLaMA whose down rows
split a group on each rank among them; the first prefill's logits within
1e-5 relative of one unsharded process's; a one-rank mesh bit-equal to no
mesh.  ``Chat`` (an upload and two greedy turns, a sampled turn) and top-p
``generate`` on the sharded Myriad give every rank the ids of one
unsharded process (tolerance 0), the greedy turns also those of the JAX
``Chat``, with the upload's expert and towers run on the group's first
rank only.  Without processes: the int4 row shards of
Vicuna-7B's down over 4 and 8 ranks, whose partial products sum to the
whole one.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myriad_tpu import checkpoint as ckpt_lib
from myriad_tpu.conversation import CONV_VISION as JAX_CONV_VISION
from myriad_tpu.conversation import Chat as JaxChat
from myriad_tpu.generation import GenerationConfig as JaxGenerationConfig
from myriad_tpu.models.layers import Policy as JaxPolicy
from myriad_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from myriad_tpu.models.llama import LlamaForCausalLM as JaxLlama
from myriad_tpu.models.myriad import MyriadArch as JaxArch
from myriad_tpu.generation import greedy_generate as jax_greedy_generate
from myriad_tpu.ops import quant as jax_quant
from myriad_tpu.ops.quant import quantize_tree
from myriad_tpu.parallel import mesh as jax_mesh
from myriad_tpu.parallel import partition as jax_partition
from myriad_tpu.processors.blip_processors import LocImageTrainProcessor
from myriad_tpu.serving import ServingEngine as JaxServingEngine
from myriad_tpu_torch.conversation import CONV_VISION, Chat
from myriad_tpu_torch.convert_from_jax import state_dict_from_jax
from myriad_tpu_torch.generation import GenerationConfig, _sampler, greedy_generate
from myriad_tpu_torch.models.layers import Policy, Quant4Dense
from myriad_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, shard_config
from myriad_tpu_torch.models.myriad import Myriad, MyriadArch
from myriad_tpu_torch.ops import quant
from myriad_tpu_torch.parallel import partition
from myriad_tpu_torch.parallel.mesh import Mesh, make_mesh
from test_torch_llama import _init_like, _perturb
from test_torch_myriad import TracedInitMyriad, _jax_variant
import torch_threads  # noqa: F401  (one torch thread a test process)

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 2
GEN = dict(max_new_tokens=8, eos_token_id=-1, stop_single=-1, stop_pair=(-1, -1))
# tests/test_serving_sharded.py's cases but the block layout (not ported)
ENGINE_CASES = {"fp32": (jnp.float32, torch.float32, 0), "int8_kv": ("int8", "int8", 0),
                "spec2": (jnp.float32, torch.float32, 2)}
# tests/test_parallel_training.py's generate runs: greedy 5 tokens, spec_k=2 6
MYRIAD_CASES = {"greedy": (0, 5), "spec2": (2, 6)}
QUESTION = "<Img><ImageHere></Img>find defects"
# down's 384 input rows are 3 groups of 128: each rank's 192 hold 1.5, rank 1's
# from offset 64 (o's 256 rows hold whole groups)
INT4_SPLIT = dict(hidden_size=256, intermediate_size=384)
CHAT_QUESTIONS = ["Is there any defect?", "Where is it?"]
CHAT_NEW = 6
SAMPLE = {"do_sample": True, "top_p": 0.9}
SAMPLE_SEED = 3


def _samples():
    return {"image": np.zeros((4, 28, 28, 3), np.float32), "scene": ["bottle"] * 4,
            "question": [QUESTION] * 4, "question2": [QUESTION] * 4,
            "question3": [QUESTION] * 4, "img_path": ["x"] * 4}


def _llama_tree(cfg, seed):
    """A JAX LLaMA's float parameters (traced initialiser, perturbed values)."""
    model = JaxLlama(cfg, jnp.float32, jnp.float32)
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init_params, jax.random.PRNGKey(seed))
    return _perturb(_init_like(shapes, rng)["params"], rng)


def _jax_shards(tree, mesh, rules):
    """Every leaf's numpy shard on each model index, and the fallbacks."""
    shardings = jax_partition.tree_shardings(tree, mesh, rules)
    fallbacks = list(jax_partition.tree_shardings.last_fallbacks)
    placed = jax.device_put(tree, shardings)
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(placed):
        name = jax_partition.param_path(path)
        out[name] = [next(np.asarray(s.data) for s in leaf.addressable_shards
                          if s.device == mesh.devices[0, r]) for r in range(WORLD)]
    return out, fallbacks


def test_rule_tables_equal_the_jax_ones():
    pairs = [(partition.LLAMA_RULES, jax_partition.LLAMA_RULES),
             (partition.VIT_RULES, jax_partition.VIT_RULES),
             (partition.IMAGEBIND_RULES, jax_partition.IMAGEBIND_RULES),
             (partition.QFORMER_RULES, jax_partition.QFORMER_RULES),
             (partition.myriad_rules(), jax_partition.myriad_rules())]
    for ours, theirs in pairs:
        assert [p for p, _ in ours] == [p for p, _ in theirs]
        assert [s for _, s in ours] == [tuple(s) for _, s in theirs]
        assert all(partition.spec_str(s) == str(t) for (_, s), (_, t) in zip(ours, theirs))


SHARD_CASES = {
    "bf16": (JaxLlamaConfig.tiny(), None),
    # a vocabulary of 129 does not split over 2: lm_head falls back to whole
    "bf16_vocab129": (JaxLlamaConfig.tiny(vocab_size=129), None),
    "int8": (JaxLlamaConfig.tiny(), "int8"),
    # group-aligned: 256 and 512 input rows are whole groups of 128 on each rank
    "int4": (JaxLlamaConfig.tiny(hidden_size=256, intermediate_size=512), "int4"),
    # down's 384 rows over 2 ranks: 1.5 groups of 128 a rank
    "int4_split": (JaxLlamaConfig.tiny(**INT4_SPLIT), "int4"),
    "lora": (JaxLlamaConfig.tiny(use_lora=True), None),
}


@pytest.mark.parametrize("case", list(SHARD_CASES))
def test_shards_equal_the_jax_arrays_shards(case):
    """``shard_state_dict`` of the bridged state against ``jax.device_put``
    under ``tree_shardings``: each rank's piece is the JAX array's shard on
    its model index, bit for bit, and the fallbacks are the same."""
    cfg, mode = SHARD_CASES[case]
    tree = _llama_tree(cfg, 4)
    if mode:
        tree = jax.tree_util.tree_map(np.asarray, quantize_tree(tree, mode=mode))
    mesh = jax_mesh.make_mesh(n_model=WORLD)
    theirs, fallbacks = _jax_shards(tree, mesh, jax_partition.LLAMA_RULES)
    state = state_dict_from_jax(tree)
    from myriad_tpu_torch.convert_from_jax import jax_leaves

    names = {name: path for path, name, _ in jax_leaves(tree)}
    for r in range(WORLD):
        ours = partition.shard_state_dict(state, Mesh(n_model=WORLD, model_rank=r),
                                          partition.LLAMA_RULES)
        assert partition.shard_state_dict.last_fallbacks == fallbacks
        assert set(ours) == set(state)
        for name, piece in ours.items():
            want = theirs[names[name]][r]
            if names[name].endswith("/kernel"):
                want = want.T
            assert piece.dtype == torch.from_numpy(np.array(want)).dtype
            assert np.array_equal(piece.numpy(), want), name
    if case == "bf16_vocab129":
        assert fallbacks and all("lm_head" in f for f in fallbacks)
    else:
        assert not fallbacks
    # the sharded module takes each rank's piece as it is
    port_cfg = LlamaConfig(**{f.name: getattr(cfg, f.name)
                              for f in dataclasses.fields(LlamaConfig)
                              if hasattr(cfg, f.name)})
    if mode:
        port_cfg = dataclasses.replace(port_cfg, weight_dtype=mode)
    mesh1 = Mesh(n_model=WORLD, model_rank=1)
    sharded = LlamaForCausalLM(port_cfg, policy=Policy.fp32(), device="cpu", mesh=mesh1)
    sharded.load_state_dict(partition.shard_state_dict(state, mesh1, partition.LLAMA_RULES),
                            strict=True)
    assert sharded.config.num_heads == cfg.num_heads // WORLD


def test_shard_shapes_the_port_refuses():
    """A model axis must divide the heads; an int4 row shard may split a
    group (down's 11008 rows over 4 ranks: 21.5 groups of 128), and keeps
    the whole weight's scale4, but its rows must pair into bytes."""
    with pytest.raises(ValueError, match="does not divide"):
        shard_config(LlamaConfig.tiny(), 3)
    for rank in range(4):
        down = Quant4Dense(2752, 16, policy=Policy.fp32(), device="cpu",
                           mesh=Mesh(n_model=4, model_rank=rank))
        assert down.w_int4.shape == (1376, 16) and down.scale4.shape == (86, 16)
    Quant4Dense(5504, 16, policy=Policy.fp32(), device="cpu", mesh=Mesh(n_model=2))
    with pytest.raises(ValueError, match="even input dim"):
        Quant4Dense(2751, 16, policy=Policy.fp32(), device="cpu", mesh=Mesh(n_model=4))


@pytest.mark.parametrize("n", [4, 8])
def test_int4_row_shards_that_split_a_group_sum_to_the_whole(n):
    """Vicuna-7B's down (11008 rows, 86 groups of 128) at N = 64 over n
    ranks: each rank's ``int4_row_groups`` view and group offset, its plain
    B5 partial (fp32) summed over the ranks within 1e-5 relative of the
    whole plain product and of the JAX ``int4_matmul`` (its Pallas kernel
    in interpret mode) on the same arrays, and its W8A8 requantization
    (over the whole weight's column scales) the whole weight's rows bit for
    bit."""
    k, kl = 11008, 11008 // n
    rng = np.random.default_rng(n)
    w4_np, s4_np = jax_quant.quantize_int4_grouped(
        jnp.asarray(rng.normal(size=(k, 64)).astype(np.float32) * 0.02))
    x_np = jnp.asarray(rng.normal(size=(8, k)).astype(np.float32)).astype(jnp.bfloat16)
    w4, s4 = torch.from_numpy(np.array(w4_np)), torch.from_numpy(np.array(s4_np))
    x = torch.from_numpy(np.asarray(x_np.astype(jnp.float32))).bfloat16()
    whole = quant.int4_weight_only_matmul_plain(x, w4, s4, out_dtype=torch.float32)
    theirs = torch.from_numpy(np.asarray(jax.jit(functools.partial(
        jax_quant.int4_matmul, out_dtype=jnp.float32, interpret=True))(x_np, w4_np, s4_np)))
    w8_whole, s_col = quant.requantize_int4_to_int8(w4, s4)
    total, offsets = torch.zeros_like(whole), []
    for r in range(n):
        view, goff, group = quant.int4_row_groups(s4, kl, Mesh(n_model=n, model_rank=r))
        first, last = r * kl // 128, -(-(r + 1) * kl // 128)
        assert group == 128 and goff == r * kl % 128
        assert view.data_ptr() == s4[first].data_ptr() and view.shape == (last - first, 64)
        piece = w4[r * kl // 2:(r + 1) * kl // 2]
        total += quant.int4_weight_only_matmul(x[:, r * kl:(r + 1) * kl], piece, view,
                                               out_dtype=torch.float32, goff=goff, group=group)
        w8, _ = quant.requantize_int4_to_int8(piece, view, s_col, goff, group)
        assert torch.equal(w8, w8_whole[r * kl:(r + 1) * kl])
        offsets.append(goff)
    assert offsets == {4: [0, 64, 0, 64], 8: [0, 96, 64, 32, 0, 96, 64, 32]}[n]
    for ref in (whole, theirs):
        assert ((total - ref).norm() / ref.norm()).item() <= 1e-5


def test_sampled_decode_needs_the_ranks_generators_in_one_state():
    """A sampled decode over a model group draws on every rank from its own
    generator: ``_sampler`` gathers their states' digests once and raises
    on every rank where they differ."""
    class TwoRanks:  # a model group whose other rank's digest is ours, or one more
        device = torch.device("cpu")

        def __init__(self, shift):
            self.shift = shift

        def all_gather(self, t):
            return torch.cat([t, t + self.shift], dim=-1)

    cfg = GenerationConfig(do_sample=True)
    gen = torch.Generator().manual_seed(0)
    assert _sampler(cfg, gen, "cpu", TwoRanks(0)) is gen
    with pytest.raises(ValueError, match="one state"):
        _sampler(cfg, None, "cpu", TwoRanks(1))
    assert _sampler(GenerationConfig(), None, "cpu", TwoRanks(1)) is None


@pytest.fixture(scope="module")
def engine_inputs():
    cfg = JaxLlamaConfig.tiny()
    params = _llama_tree(cfg, 3)
    rng = np.random.default_rng(2)
    prompts = [rng.normal(size=(t, cfg.hidden_size)).astype(np.float32) * 0.15
               for t in (11, 5, 9)]
    return cfg, params, prompts


@pytest.fixture(scope="module")
def int4_inputs():
    """The int4 LLaMA whose down rows split a group (float weights from a
    seed, quantized by the JAX ``quantize_tree``), the engine's prompts and
    a prefix for ``greedy_generate``."""
    cfg = JaxLlamaConfig.tiny(**INT4_SPLIT)
    tree = jax.tree_util.tree_map(np.asarray, quantize_tree(_llama_tree(cfg, 5), mode="int4"))
    rng = np.random.default_rng(6)
    prompts = [rng.normal(size=(t, cfg.hidden_size)).astype(np.float32) * 0.15
               for t in (11, 5, 9)]
    prefix = rng.normal(size=(2, 9, cfg.hidden_size)).astype(np.float32) * 0.15
    return dataclasses.replace(cfg, weight_dtype="int4"), tree, prompts, prefix


def _chat_image():
    return np.random.default_rng(8).integers(0, 255, (28, 28, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_myriad():
    jm = TracedInitMyriad(arch=JaxArch.tiny(), use_ve=False, policy=JaxPolicy.fp32(),
                          max_txt_len=16, end_sym="###")
    params = jax.tree_util.tree_map(np.asarray, jm.params)
    jm.trainable, jm.frozen = ckpt_lib.split_by_predicate(params, jm._trainable_predicate())
    return jm, params


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, engine_inputs, jax_myriad, int4_inputs):
    """The two gloo ranks' results over every case (one start for all)."""
    _, params, prompts = engine_inputs
    _, mparams = jax_myriad
    _, tree4, prompts4, prefix4 = int4_inputs
    d = tmp_path_factory.mktemp("tp")
    inputs = d / "inputs.pt"
    torch.save({"engine": {"state": state_dict_from_jax(params), "prompts": prompts,
                           "gen": GEN,
                           "cases": {k: (v[1], v[2]) for k, v in ENGINE_CASES.items()}},
                "myriad": {"state": state_dict_from_jax(mparams), "samples": _samples(),
                           "cases": MYRIAD_CASES},
                "int4": {"state": state_dict_from_jax(tree4), "prompts": prompts4,
                         "prefix": prefix4, "gen": GEN,
                         "config": dict(INT4_SPLIT, weight_dtype="int4")},
                "chat": {"image": _chat_image(), "questions": CHAT_QUESTIONS, "new": CHAT_NEW,
                         "sample": SAMPLE, "seed": SAMPLE_SEED}}, inputs)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_tp_worker.py"), str(r),
                               str(WORLD), str(d / "store"), str(inputs), str(d / f"out{r}.pt")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [torch.load(d / f"out{r}.pt", weights_only=False) for r in range(WORLD)]


def test_ranks_join_one_model_group(ranks):
    assert [r["model_rank"] for r in ranks] == list(range(WORLD))
    assert all(r["backend"] == "gloo" for r in ranks)
    assert all("not divisible by model axis 3" in r["refused"] for r in ranks)


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_sharded_engine_matches_the_jax_sharded_engine(case, engine_inputs, ranks):
    """tests/test_serving_sharded.py's schedule: the two ranks' token ids
    equal the JAX engine's under GSPMD over ``model=2`` (tolerance 0), and
    each rank's KV pool holds its heads."""
    cfg, params, prompts = engine_inputs
    jax_dtype, _, spec_k = ENGINE_CASES[case]
    mesh = jax_mesh.make_mesh(n_model=WORLD)
    model = JaxLlama(cfg, jnp.float32, jnp.float32)
    tree = {"params": params}
    placed = jax.device_put(tree, jax_partition.tree_shardings(tree, mesh,
                                                               jax_partition.LLAMA_RULES))
    eng = JaxServingEngine(model, placed, slots=2, bucket=64,
                           config=JaxGenerationConfig(**GEN), cache_dtype=jax_dtype, segment=4,
                           admit_widths=(8, 16), mesh=mesh, spec_k=spec_k)
    for i, p in enumerate(prompts):
        eng.submit(jnp.asarray(p), request_id=i)
    done = {f.request_id: np.asarray(f.tokens).tolist() for f in eng.drain()}
    want = [done[i] for i in range(len(prompts))]
    for r in ranks:
        got = r["engine"][case]
        assert got["tokens"] == want
        assert got["cache_heads"] == cfg.num_heads // WORLD
    # one schedule on every rank: the counters agree (the walls are clocks)
    counters = [{k: v for k, v in r["engine"][case]["stats"].items() if not k.endswith("_s")}
                for r in ranks]
    assert counters[0] == counters[1] and counters[0]["completed"] == len(prompts)


@pytest.fixture(scope="module")
def port_myriad(jax_myriad):
    """The unsharded port in this process: the prefill logits' reference."""
    _, params = jax_myriad
    out = {}
    for case, (spec_k, max_new) in MYRIAD_CASES.items():
        m = Myriad(MyriadArch.tiny(), policy=Policy.fp32(), device="cpu", use_ve=False,
                   max_txt_len=16, end_sym="###", spec_k=spec_k)
        m.load_state_dicts(state_dict_from_jax(params), None)
        kept = []
        orig = m.module.llama.logits
        m.module.llama.logits = lambda h, orig=orig: kept.append(orig(h)) or kept[-1]
        tokens = m.generate(_samples(), max_new_tokens=max_new)["token_ids"]
        out[case] = (m, tokens, kept[0])
    return out


@pytest.mark.parametrize("case", list(MYRIAD_CASES))
def test_sharded_generate_matches_the_jax_sharded_generate(case, jax_myriad, port_myriad,
                                                           ranks):
    """tests/test_parallel_training.py's sharded ``Myriad.generate`` (greedy,
    and spec_k=2): the two ranks' token ids equal the JAX run's under
    ``myriad_rules`` over ``model=2`` (tolerance 0); the first prefill's
    logits within 1e-5 relative of one unsharded process's."""
    jm, _ = jax_myriad
    spec_k, max_new = MYRIAD_CASES[case]
    v = _jax_variant(jm, spec_k=spec_k)
    mesh = jax_mesh.make_mesh(n_model=WORLD)
    rules = jax_partition.myriad_rules()
    v.trainable = jax.device_put(v.trainable,
                                 jax_partition.tree_shardings(v.trainable, mesh, rules))
    v.frozen = jax.device_put(v.frozen, jax_partition.tree_shardings(v.frozen, mesh, rules))
    want = np.asarray(v.generate(_samples(), max_new_tokens=max_new)["token_ids"]).tolist()
    _, tokens, logits = port_myriad[case]
    assert tokens.tolist() == want
    for r in ranks:
        got = r["myriad"][case]
        assert got["tokens"] == want
        assert got["heads"] == JaxArch.tiny().llama.num_heads // WORLD
        err = ((got["prefill"] - logits).norm() / logits.norm()).item()
        assert err <= 1e-5
    # every rank gathered the same logits: one decision from the same bits
    assert torch.equal(ranks[0]["myriad"][case]["prefill"], ranks[1]["myriad"][case]["prefill"])
    calls = ranks[0]["myriad"][case]["calls"]
    assert calls["broadcast"] == 2 and calls["all_reduce_sum"] > 0 and calls["all_gather"] > 0


def test_one_rank_mesh_is_no_mesh(port_myriad):
    """``make_mesh(1)`` has no process group: ``Myriad.shard`` keeps the
    whole model, and a LLaMA built with it is the unsharded one, bit for
    bit."""
    mesh = make_mesh(1, device="cpu")
    assert not mesh.sharded and mesh.model_group is None
    m, tokens, logits = port_myriad["greedy"]
    llama = m.module.llama
    assert m.shard(mesh) is m and m.mesh is None and m.module.llama is llama
    cfg = MyriadArch.tiny().llama
    one = LlamaForCausalLM(cfg, policy=Policy.fp32(), device="cpu", mesh=mesh)
    plain = LlamaForCausalLM(cfg, policy=Policy.fp32(), device="cpu")
    state = llama.state_dict()
    one.load_state_dict(state, strict=True)
    plain.load_state_dict(state, strict=True)
    embeds = torch.from_numpy(np.random.default_rng(9).normal(size=(2, 11, 64)).astype(
        np.float32) * 0.3)
    gen = GenerationConfig(max_new_tokens=6)
    assert torch.equal(greedy_generate(one, embeds, config=gen),
                       greedy_generate(plain, embeds, config=gen))


@pytest.fixture(scope="module")
def jax_int4(int4_inputs):
    """The JAX int4 LLaMA and its parameters placed under ``LLAMA_RULES`` over
    ``model=2`` (down's w_int4 rows split, scale4 replicated)."""
    cfg, tree, _, _ = int4_inputs
    mesh = jax_mesh.make_mesh(n_model=WORLD)
    tree = {"params": tree}
    placed = jax.device_put(tree, jax_partition.tree_shardings(tree, mesh,
                                                               jax_partition.LLAMA_RULES))
    return JaxLlama(cfg, jnp.float32, jnp.float32), placed, mesh


def test_int4_split_engine_matches_the_jax_sharded_engine(int4_inputs, jax_int4, ranks):
    """The engine (fp32 cache) over an int4 LLaMA whose down rows split a
    group on each rank: the two ranks' token ids equal the JAX engine's
    under GSPMD over ``model=2`` (tolerance 0)."""
    _, _, prompts, _ = int4_inputs
    model, placed, mesh = jax_int4
    eng = JaxServingEngine(model, placed, slots=2, bucket=64,
                           config=JaxGenerationConfig(**GEN), cache_dtype=jnp.float32,
                           segment=4, admit_widths=(8, 16), mesh=mesh)
    for i, p in enumerate(prompts):
        eng.submit(jnp.asarray(p), request_id=i)
    done = {f.request_id: np.asarray(f.tokens).tolist() for f in eng.drain()}
    for r in ranks:
        assert r["int4"]["engine"] == [done[i] for i in range(len(prompts))]
        assert r["int4"]["down_rows"] == INT4_SPLIT["intermediate_size"] // WORLD


def test_int4_split_generate_matches_the_jax_sharded_generate(int4_inputs, jax_int4, ranks):
    """``greedy_generate`` on the same int4 shards: the two ranks' token ids
    equal the JAX one's compiled under GSPMD (tolerance 0), and every
    rank's w_int4 pieces are the JAX arrays' shards bit for bit."""
    _, tree, _, prefix = int4_inputs
    model, placed, mesh = jax_int4
    want = jax.jit(lambda p, e: jax_greedy_generate(
        model, p, e, config=JaxGenerationConfig(**GEN), cache_dtype=jnp.float32))(
            placed, jnp.asarray(prefix))
    theirs, _ = _jax_shards(tree, mesh, jax_partition.LLAMA_RULES)
    from myriad_tpu_torch.convert_from_jax import jax_leaves

    names = {name: path for path, name, _ in jax_leaves(tree)}
    for r in ranks:
        assert r["int4"]["generate"] == np.asarray(want).tolist()
        pieces = r["int4"]["w_int4"]
        assert len(pieces) == 7 * JaxLlamaConfig.tiny().num_layers  # q, k, v, o, gate, up, down
        for name, piece in pieces.items():
            assert np.array_equal(piece.numpy(), theirs[names[name]][r["model_rank"]]), name


@pytest.fixture(scope="module")
def jax_chat(jax_myriad):
    """The JAX package's greedy two-turn ``Chat`` on the same weights, image
    and questions, the upload normalised by the reference demo's processor
    (``LocImageTrainProcessor(identity=True)``, the port's bytes)."""
    jm, _ = jax_myriad
    chat = JaxChat(_jax_variant(jm), LocImageTrainProcessor(identity=True))
    conv, img_list = JAX_CONV_VISION.copy(), []
    chat.upload_img(_chat_image(), conv, img_list)
    out = []
    for q in CHAT_QUESTIONS:
        chat.ask(q, conv)
        out.append(np.asarray(chat.answer(conv, img_list, max_new_tokens=CHAT_NEW)[1]).tolist())
    return {"tokens": out, "deltas": list(chat._delta_log)}


@pytest.fixture(scope="module")
def one_process_chat(jax_myriad):
    """The unsharded port's greedy two-turn ``Chat``, a sampled turn and a
    top-p ``generate``, in this process."""
    _, params = jax_myriad
    m = Myriad(MyriadArch.tiny(), policy=Policy.fp32(), device="cpu", use_ve=False,
               max_txt_len=16, end_sym="###")
    m.load_state_dicts(state_dict_from_jax(params), None)

    def run(questions, **answer_kw):
        chat = Chat(m)
        conv, img_list = CONV_VISION.copy(), []
        chat.upload_img(_chat_image(), conv, img_list)
        out = []
        for q in questions:
            chat.ask(q, conv)
            out.append(chat.answer(conv, img_list, max_new_tokens=CHAT_NEW,
                                   **answer_kw)[1].tolist())
        return {"tokens": out, "deltas": chat._delta_log, "image_tokens": img_list[0]}

    top_p = m.generate(_samples(), max_new_tokens=CHAT_NEW, seed=SAMPLE_SEED, **SAMPLE)
    return {"greedy": run(CHAT_QUESTIONS), "sampled": run(CHAT_QUESTIONS[:1], **SAMPLE),
            "top_p": top_p["token_ids"].tolist()}


def test_sharded_chat_matches_one_process(jax_chat, one_process_chat, ranks):
    """An upload and two greedy turns of the incremental ``Chat`` on the
    sharded Myriad: every rank's ids and prefill widths equal the JAX
    ``Chat``'s and one unsharded process's (tolerance 0), the image tokens
    are the unsharded process's bits, the resident cache holds the rank's
    heads, and the upload's normalisation, expert maps and towers ran on
    the group's first rank alone (one broadcast)."""
    want = one_process_chat["greedy"]
    assert want["tokens"] == jax_chat["tokens"] and want["deltas"] == jax_chat["deltas"]
    for r in ranks:
        got = r["chat"]["greedy"]
        assert got["tokens"] == jax_chat["tokens"] and got["deltas"] == jax_chat["deltas"]
        assert got["tokens"] == want["tokens"] and len(got["tokens"]) == len(CHAT_QUESTIONS)
        assert got["deltas"] == want["deltas"]
        assert torch.equal(got["image_tokens"], want["image_tokens"])
        assert got["cache_heads"] == JaxArch.tiny().llama.num_heads // WORLD
        assert got["upload_calls"] == {"broadcast": 1}
    assert [r["chat"]["runs"] for r in ranks] == [{"normalise": 2, "maps": 2, "towers": 2},
                                                  {"normalise": 0, "maps": 0, "towers": 0}]


@pytest.mark.parametrize("case", ["sampled", "top_p"])
def test_sampled_decode_draws_alike_on_every_rank(case, one_process_chat, ranks):
    """A sampled ``Chat.answer`` (top-p 0.9, seed 0 a turn) and a top-p
    ``generate`` (seed 3) on the sharded Myriad: every rank draws the ids of
    one unsharded process with the same seed (tolerance 0)."""
    want = one_process_chat[case]
    if case == "sampled":
        want = want["tokens"]
    for r in ranks:
        got = r["chat"][case]
        assert (got["tokens"] if case == "sampled" else got) == want
