"""The port's speculative decoding and resident-cache continuation
(``myriad_tpu_torch/generation.py``) against the JAX package's, on the CPU,
at ``LlamaConfig.tiny`` with int8 weights and an int8 KV cache and the same
random weights on both sides (fp32 compute).

Gates: token ids identical, and the three acceptance counters (accepted,
drafted, rounds) identical.  The port's greedy transcript (itself identical
to JAX's, tests/test_torch_llama.py) seeds the lookup and oracle drafts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myriad_tpu import generation as jgen
from myriad_tpu.models.llama import init_cache as jax_init_cache
from myriad_tpu_torch import generation as gen
from myriad_tpu_torch.models.llama import init_cache
from test_torch_llama import _models
import torch_threads  # noqa: F401  (one torch thread a test process)

NO_STOP = dict(eos_token_id=-1, stop_single=-1, stop_pair=(-1, -1))
NEW = 14


@pytest.fixture(scope="module")
def setup():
    jmodel, params, tmodel = _models("int8", "int8")
    x = np.random.default_rng(3).normal(size=(2, 7, 64)).astype(np.float32)
    greedy = gen.greedy_generate(tmodel, torch.from_numpy(x),
                                 config=gen.GenerationConfig(max_new_tokens=NEW, **NO_STOP),
                                 cache_dtype="int8").numpy()
    return jmodel, params, tmodel, x, greedy


def _drafts(case, greedy):
    """(lookup_ids, oracle_drafts) of a case, as numpy arrays or None."""
    if case == "lookup":
        return greedy[0], None       # row 0's own continuation: hits in row 0 only
    if case == "oracle":
        return None, greedy          # full acceptance
    if case == "mixed":
        drafts = greedy.copy()
        drafts[1, ::2] = 31999       # out of the vocab (clamped), then garbage
        drafts[1, 1::2] = 1
        return None, drafts          # row 0 accepts all, row 1 about none
    return None, None                # the rows' own tokens only


def _both(setup, k, case, stops=None):
    jmodel, params, tmodel, x, greedy = setup
    kw = dict(max_new_tokens=NEW, **(stops or NO_STOP))
    lookup, oracle = _drafts(case, greedy)
    ref, ref_stats = jgen.speculative_generate(
        jmodel, params, jnp.asarray(x), config=jgen.GenerationConfig(**kw), spec_k=k,
        lookup_ids=None if lookup is None else jnp.asarray(lookup),
        oracle_drafts=None if oracle is None else jnp.asarray(oracle),
        cache_dtype="int8", return_stats=True)
    out, stats = gen.speculative_generate(
        tmodel, torch.from_numpy(x), config=gen.GenerationConfig(**kw), spec_k=k,
        lookup_ids=None if lookup is None else torch.from_numpy(lookup),
        oracle_drafts=None if oracle is None else torch.from_numpy(oracle),
        cache_dtype="int8", return_stats=True)
    return out.numpy(), stats, np.asarray(ref), {n: int(v) for n, v in ref_stats.items()}


@pytest.mark.parametrize("k,case", [(1, "lookup"), (3, "lookup"), (3, "self"),
                                    (3, "oracle"), (3, "mixed")])
def test_spec_matches_jax(setup, k, case):
    out, stats, ref, ref_stats = _both(setup, k, case)
    np.testing.assert_array_equal(out, ref)
    assert stats == ref_stats
    np.testing.assert_array_equal(out, setup[4])  # transcript-exact against greedy
    if case == "oracle":  # every round accepts all K drafts
        assert stats["rounds"] == -(-NEW // (k + 1))


def test_spec_stop_pair_matches_jax(setup):
    row = setup[4][0]
    i = len(row) // 2
    stops = dict(eos_token_id=-1, stop_single=-1, stop_pair=(int(row[i]), int(row[i + 1])))
    out, stats, ref, ref_stats = _both(setup, 3, "lookup", stops)
    np.testing.assert_array_equal(out, ref)
    assert stats == ref_stats
    assert (out[0, i + 1:] == 0).all()  # the pair's second token truncated row 0


def _prompt_cache_jax(jmodel, params, x, bucket):
    cache = jax_init_cache(jmodel.config, 2, bucket, "int8")
    _, cache = jgen._prefill(jmodel, params, jnp.asarray(x), cache, 1)
    return cache


def _prompt_cache_torch(tmodel, x, bucket):
    cache = init_cache(tmodel.config, 2, bucket, "int8", "cpu")
    with torch.inference_mode():
        gen._prefill(tmodel, torch.from_numpy(x), cache, 1)
    return cache


def test_spec_continuation_matches_jax(setup):
    """Continuation mode (the resident-cache chat): a 7-position prompt is in
    the cache, a 5-column delta (3 valid, 2 pad) is prefilled at its frontier
    and decoded speculatively; the returned cache's frontier is the
    post-prefill one."""
    jmodel, params, tmodel, x, greedy = setup
    delta = np.random.default_rng(4).normal(size=(2, 5, 64)).astype(np.float32)
    kw = dict(max_new_tokens=10, **NO_STOP)
    (ref, ref_stats), jcache = jgen.speculative_generate(
        jmodel, params, jnp.asarray(delta), config=jgen.GenerationConfig(**kw), spec_k=3,
        lookup_ids=jnp.asarray(greedy), cache=_prompt_cache_jax(jmodel, params, x, 32),
        valid_len=3, return_stats=True, return_cache=True)
    (out, stats), cache = gen.speculative_generate(
        tmodel, torch.from_numpy(delta), config=gen.GenerationConfig(**kw), spec_k=3,
        lookup_ids=torch.from_numpy(greedy), cache=_prompt_cache_torch(tmodel, x, 32),
        valid_len=3, return_stats=True, return_cache=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert stats == {n: int(v) for n, v in ref_stats.items()}
    assert cache[0]["index"] == int(jcache[0]["index"]) == 10


def test_continue_generate_two_deltas_matches_jax(setup):
    """Two chat turns through ``continue_generate`` with right-padded deltas
    and ``valid_len``.  Turn 2's delta (3 positions) is shorter than turn 1's
    decode (8 positions), so the port's in-place cache holds turn 1's decode
    scratch on both sides of turn 2's frontier, where the JAX package's
    functional cache holds none: the tokens must not see it."""
    jmodel, params, tmodel, x, _ = setup
    rng = np.random.default_rng(5)
    deltas = [(rng.normal(size=(2, 8, 64)).astype(np.float32), 6),
              (rng.normal(size=(2, 4, 64)).astype(np.float32), 3)]
    cfg_kw = dict(max_new_tokens=8, **NO_STOP)
    jcache = _prompt_cache_jax(jmodel, params, x, 48)
    cache = _prompt_cache_torch(tmodel, x, 48)
    for turn, (delta, valid) in enumerate(deltas):
        ref, jcache = jgen.continue_generate(jmodel, params, jnp.asarray(delta), jcache,
                                             config=jgen.GenerationConfig(**cfg_kw),
                                             valid_len=valid)
        out, cache = gen.continue_generate(tmodel, torch.from_numpy(delta), cache,
                                           config=gen.GenerationConfig(**cfg_kw),
                                           valid_len=valid)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref), err_msg=f"turn {turn}")
        assert cache[0]["index"] == int(jcache[0]["index"])
        if turn == 0:
            # decode scratch sits past the returned frontier (13) in the port only
            scratch = cache[0]["k_scale"][:, :, 13:20].float()
            assert bool((scratch != 0).all())
            assert not np.asarray(jcache[0]["k_scale"][:, :, 15:20]).any()


@pytest.mark.parametrize("last_index", [4, [2, 6], None])
def test_prefill_last_index_matches_jax(setup, last_index):
    """``prefill(last_index=...)`` reads one column: an int for every row, a
    (B,) vector per row, or the last column by default."""
    from myriad_tpu.models.llama import LlamaForCausalLM as JaxLlama

    jmodel, params, tmodel, x, _ = setup
    jli = None if last_index is None else jnp.asarray(last_index, jnp.int32)
    ref, _ = jmodel.apply(params, jnp.asarray(x),
                          cache=jax_init_cache(jmodel.config, 2, 16, "int8"),
                          last_index=jli, method=JaxLlama.prefill)
    tli = last_index if not isinstance(last_index, list) else torch.tensor(last_index)
    with torch.inference_mode():
        cache = init_cache(tmodel.config, 2, 16, "int8", "cpu")
        out = tmodel.prefill(torch.from_numpy(x), cache, last_index=tli)
    assert out.shape == (2, 1, 128)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
