"""The port's LLaMA and greedy generation (myriad_tpu_torch/models/llama.py,
myriad_tpu_torch/generation.py) against the JAX package's, on the CPU, at
``LlamaConfig.tiny`` with the same random weights on both sides (fp32 compute).

Tolerances: prefill logits within 1e-4 (fp32 sums in another order); greedy
token ids identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myriad_tpu import generation as jgen
from myriad_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from myriad_tpu.models.llama import LlamaForCausalLM as JaxLlama
from myriad_tpu.models.llama import init_cache as jax_init_cache
from myriad_tpu.ops.quant import quantize_tree
from myriad_tpu_torch import generation as gen
from myriad_tpu_torch.convert_from_jax import state_dict_from_jax
from myriad_tpu_torch.models.layers import Policy
from myriad_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, init_cache

STOPS = dict(eos_token_id=2, stop_single=5, stop_pair=(7, 9), pad_token_id=0)


def _perturb(tree, rng, std=0.2):
    """Random offsets on every float leaf (norm weights and biases included),
    so that no parameter is left at a trivial init value."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng, std)
        else:
            a = np.asarray(v)
            out[k] = a + rng.normal(size=a.shape).astype(a.dtype) * std if a.dtype.kind == "f" else a
    return out


def _models(weight_dtype, kv_dtype, seed=0):
    jcfg = JaxLlamaConfig.tiny(kv_cache_dtype=kv_dtype)
    params = JaxLlama(jcfg, jnp.float32, jnp.float32).init_params(jax.random.PRNGKey(seed))
    params = _perturb(jax.tree_util.tree_map(np.asarray, params["params"]),
                      np.random.default_rng(seed))
    if weight_dtype == "int8":
        params = quantize_tree(params)
        jcfg = dataclasses.replace(jcfg, weight_dtype="int8")
    jmodel = JaxLlama(jcfg, jnp.float32, jnp.float32)
    cfg = LlamaConfig.tiny(weight_dtype=weight_dtype, kv_cache_dtype=kv_dtype)
    tmodel = LlamaForCausalLM(cfg, policy=Policy.fp32(), device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(params), strict=True)
    return jmodel, {"params": params}, tmodel


@pytest.fixture(scope="module")
def int8_models():
    return _models("int8", "int8")


def _embeds(b=2, p=21, seed=3):
    return np.random.default_rng(seed).normal(size=(b, p, 64)).astype(np.float32)


@pytest.mark.parametrize("kv", ["int8", "bf16"])
def test_prefill_logits_match(kv):
    jmodel, params, tmodel = _models("int8", kv)
    x = _embeds()
    cache_dtype = "int8" if kv == "int8" else jnp.float32
    ref, _ = jmodel.apply(params, jnp.asarray(x),
                          cache=jax_init_cache(jmodel.config, 2, 32, cache_dtype),
                          method=JaxLlama.prefill)
    with torch.inference_mode():
        cache = init_cache(tmodel.config, 2, 32, "int8" if kv == "int8" else torch.float32,
                           "cpu")
        out = tmodel.prefill(torch.from_numpy(x), cache)
    assert out.shape == (2, 1, 128) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    assert cache[0]["index"] == 21
    if kv == "int8":
        assert cache[0]["k_scale"].dtype == torch.float16


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("chunks", [1, 3])
def test_greedy_generate_token_ids_identical(int8_models, chunks, staged):
    jmodel, params, tmodel = int8_models
    x = _embeds()
    kw = dict(max_new_tokens=12, prefill_chunks=chunks, staged_decode=staged,
              cache_granularity=8, **STOPS)
    ref = jgen.greedy_generate(jmodel, params, jnp.asarray(x),
                               config=jgen.GenerationConfig(**kw), cache_dtype="int8")
    out = gen.greedy_generate(tmodel, torch.from_numpy(x),
                              config=gen.GenerationConfig(**kw), cache_dtype="int8")
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_greedy_generate_float_weights_float_cache():
    jmodel, params, tmodel = _models("bf16", "bf16", seed=1)
    x = _embeds(p=13)
    kw = dict(max_new_tokens=10, prefill_chunks=2, staged_decode=True, cache_granularity=8,
              **STOPS)
    ref = jgen.greedy_generate(jmodel, params, jnp.asarray(x),
                               config=jgen.GenerationConfig(**kw), cache_dtype=jnp.float32)
    out = gen.greedy_generate(tmodel, torch.from_numpy(x),
                              config=gen.GenerationConfig(**kw), cache_dtype=torch.float32)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_chunk_count_matches():
    for p in range(1, 40):
        for want in range(0, 12):
            assert gen._chunk_count(p, want) == jgen._chunk_count(p, want), (p, want)


def test_staged_decode_spans():
    cfg = gen.GenerationConfig(max_new_tokens=90, cache_granularity=32, staged_decode=True)
    # the full-width AQA prefix: 297 positions into a 416-slot bucket
    assert gen.decode_stages(297, cfg) == [(320, 23), (352, 55), (384, 87), (416, 89)]
    flat = dataclasses.replace(cfg, staged_decode=False)
    assert gen.decode_stages(297, flat) == [(416, 89)]


def test_trim_stop_ids_matches():
    cfg_j = jgen.GenerationConfig(**STOPS)
    cfg_t = gen.GenerationConfig(**STOPS)
    rows = [[11, 12, 2, 13], [11, 7, 9, 4], [5, 1], [20, 21, 22], [7, 7, 9, 0], [0, 3]]
    for row in rows:
        assert gen.trim_stop_ids(row, cfg_t) == jgen.trim_stop_ids(row, cfg_j), row


def test_finished_rows_emit_pad(int8_models):
    """A row that emits a stop id pads every later position."""
    _, _, tmodel = int8_models
    x = torch.from_numpy(_embeds())
    with torch.inference_mode():
        cache = init_cache(tmodel.config, 2, 32, "int8", "cpu")
        first = gen._select_token(gen._prefill(tmodel, x, cache, 1)[:, -1], gen.GenerationConfig())
    cfg = gen.GenerationConfig(max_new_tokens=6, eos_token_id=int(first[0]), pad_token_id=0,
                               stop_single=5, stop_pair=(7, 9))
    out = gen.greedy_generate(tmodel, x, config=cfg, cache_dtype="int8")
    assert out[0].tolist() == [0] * 6
