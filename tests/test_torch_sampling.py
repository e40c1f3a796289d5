"""Top-p sampling in the port (``generation.top_p_filter`` and
``_select_token``, ``greedy_generate``, ``continue_generate``,
``Myriad.generate``) against the JAX package's nucleus rule, on the CPU.

JAX's and torch's random streams differ, so the sampled ids are compared
with the JAX package's only where the nucleus holds one token (identical
ids).  Elsewhere the kept-token sets are compared (identical, tolerance 0:
the JAX set is read out of its ``_select_token`` by standing in for its
categorical draw), every port draw is held to its step's set, the same
``torch.Generator`` seed gives the same tokens, and the draws' frequencies
follow the nucleus's probabilities (within 0.015 over 40,000 draws).  The
serving engine rejects a sampled config, as the JAX engine does.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myriad_tpu import generation as jgen
from myriad_tpu_torch import generation
from myriad_tpu_torch.generation import GenerationConfig, top_p_filter
from myriad_tpu_torch.models.layers import Policy, init_random_
from myriad_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, init_cache
from myriad_tpu_torch.models.myriad import Myriad, MyriadArch
import torch_threads  # noqa: F401  (one torch thread a test process)

TOP_PS = (0.05, 0.5, 0.9, 0.99)
TEMPERATURES = (0.7, 1.0, 1.5)


def jax_nucleus(logits, top_p: float, temperature: float) -> np.ndarray:
    """The JAX ``_select_token``'s kept set (bool (B, V)) on ``logits``: its
    categorical draw is stood in for by the finiteness of the masked logits
    it is given."""
    cfg = jgen.GenerationConfig(do_sample=True, top_p=top_p, temperature=temperature)
    with mock.patch.object(jax.random, "categorical",
                           lambda key, masked, axis=-1: jnp.isfinite(masked)):
        kept = jgen._select_token(jnp.asarray(np.asarray(logits, np.float32)), cfg,
                                  jax.random.PRNGKey(0))
    return np.asarray(kept).astype(bool)


def _logits(seed, rows=6, vocab=64, scale=3.0):
    return torch.from_numpy(
        (np.random.default_rng(seed).normal(size=(rows, vocab)) * scale).astype(np.float32))


@pytest.mark.parametrize("temperature", TEMPERATURES)
@pytest.mark.parametrize("top_p", TOP_PS)
def test_kept_set_is_the_jax_nucleus(top_p, temperature):
    logits = _logits(int(top_p * 100 + temperature * 10))
    cfg = GenerationConfig(do_sample=True, top_p=top_p, temperature=temperature)
    kept = torch.isfinite(top_p_filter(logits, cfg)).numpy()
    np.testing.assert_array_equal(kept, jax_nucleus(logits, top_p, temperature))
    g = torch.Generator().manual_seed(1)
    for _ in range(8):
        ids = generation._select_token(logits, cfg, g).numpy()
        assert kept[np.arange(len(ids)), ids].all()


@pytest.mark.parametrize("temperature", TEMPERATURES)
def test_one_token_nucleus_gives_the_jax_ids(temperature):
    """A top_p below every token's probability keeps the argmax alone: the
    sampled ids equal the JAX package's sampled ids and the greedy ones."""
    logits = _logits(7)
    cfg = GenerationConfig(do_sample=True, top_p=1e-9, temperature=temperature)
    assert torch.isfinite(top_p_filter(logits, cfg)).sum(dim=-1).eq(1).all()
    ref = jgen._select_token(jnp.asarray(logits.numpy()),
                             jgen.GenerationConfig(do_sample=True, top_p=1e-9,
                                                   temperature=temperature),
                             jax.random.PRNGKey(3))
    ids = generation._select_token(logits, cfg, torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(ids.numpy(), logits.argmax(-1).numpy())


def test_draws_follow_the_nucleus_probabilities():
    """40,000 draws of one row: each token's frequency within 0.015 of its
    probability under the temperature-scaled nucleus; outside it, none."""
    logits = _logits(11, rows=1, vocab=12, scale=1.0).expand(40_000, 12).contiguous()
    cfg = GenerationConfig(do_sample=True, top_p=0.8, temperature=1.3)
    masked = top_p_filter(logits[:1], cfg)
    probs = torch.softmax(masked, dim=-1)[0].numpy()
    ids = generation._select_token(logits, cfg, torch.Generator().manual_seed(2)).numpy()
    freq = np.bincount(ids, minlength=12) / len(ids)
    assert np.abs(freq - probs).max() <= 0.015, (freq, probs)
    assert (freq[probs == 0] == 0).all() and (probs == 0).any()


def test_same_seed_same_draws():
    logits = _logits(5, rows=32)
    cfg = GenerationConfig(do_sample=True, top_p=0.95, temperature=1.0)
    draw = lambda seed: generation._select_token(logits, cfg,
                                                 torch.Generator().manual_seed(seed))
    torch.testing.assert_close(draw(4), draw(4), rtol=0, atol=0)
    assert not torch.equal(draw(4), draw(5))


@pytest.fixture(scope="module")
def llama():
    model = LlamaForCausalLM(LlamaConfig.tiny(), policy=Policy.fp32(), device="cpu")
    init_random_(model, torch.Generator().manual_seed(0), std=0.3)
    return model


@pytest.fixture
def record(monkeypatch):
    """Every ``_select_token`` call of the decode: (logits, config, ids)."""
    steps = []
    real = generation._select_token

    def wrapped(logits, cfg, generator=None):
        ids = real(logits, cfg, generator)
        steps.append((logits.clone(), cfg, ids.clone()))
        return ids

    monkeypatch.setattr(generation, "_select_token", wrapped)
    return steps


def _held_to_the_nucleus(steps):
    """Each recorded draw lies in its step's kept set, which is the JAX
    nucleus; returns the largest set's size."""
    widest = 0
    for logits, cfg, ids in steps:
        kept = jax_nucleus(logits, cfg.top_p, cfg.temperature)
        np.testing.assert_array_equal(torch.isfinite(top_p_filter(logits, cfg)).numpy(), kept)
        assert kept[np.arange(len(ids)), ids.numpy()].all()
        widest = max(widest, int(kept.sum(-1).max()))
    return widest


def test_greedy_generate_samples_from_the_nucleus(llama, record):
    embeds = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 5, 64)).astype(
        np.float32))
    assert embeds.shape[-1] == llama.config.hidden_size
    cfg = GenerationConfig(max_new_tokens=12, do_sample=True, top_p=0.9, temperature=1.2,
                           cache_granularity=16, staged_decode=True, stop_single=-1,
                           eos_token_id=-1, stop_pair=(-1, -1))
    run = lambda seed: generation.greedy_generate(llama, embeds, config=cfg,
                                                  generator=torch.Generator().manual_seed(seed))
    first = run(7)
    assert len(record) == cfg.max_new_tokens  # every token is a draw (no stop id)
    assert _held_to_the_nucleus(record) > 1
    torch.testing.assert_close(run(7), first, rtol=0, atol=0)
    assert not torch.equal(run(8), first)
    # without a generator a sampled decode seeds one with 0, as JAX takes PRNGKey(0)
    torch.testing.assert_close(generation.greedy_generate(llama, embeds, config=cfg), run(0),
                               rtol=0, atol=0)


def test_continue_generate_samples_from_the_nucleus(llama, record):
    rng = np.random.default_rng(1)
    prefix, delta = (torch.from_numpy(rng.normal(size=(2, n, 64)).astype(np.float32))
                     for n in (6, 3))
    cfg = GenerationConfig(max_new_tokens=8, do_sample=True, top_p=0.9, stop_single=-1,
                           eos_token_id=-1, stop_pair=(-1, -1))

    def run(seed):
        cache = init_cache(llama.config, 2, 32, torch.float32, "cpu")
        llama.prefill(prefix, cache)
        return generation.continue_generate(llama, delta, cache, config=cfg,
                                            generator=torch.Generator().manual_seed(seed))

    tokens, cache = run(2)
    assert cache[0]["index"] == 9
    assert _held_to_the_nucleus(record) > 1
    torch.testing.assert_close(run(2)[0], tokens, rtol=0, atol=0)


def test_myriad_generate_samples_by_seed():
    """``Myriad.generate`` with ``do_sample``: the same seed, the same tokens;
    a one-token nucleus at T = 1.5 (not routed to greedy) gives the greedy
    tokens."""
    model = Myriad(MyriadArch.tiny(), policy=Policy.fp32(), device="cpu",
                   class_names=["bottle", "cable"])
    model.init_random(0)
    rng = np.random.default_rng(3)
    samples = {"image": rng.integers(0, 256, (2, 28, 28, 3), dtype=np.uint8),
               "scene": ["bottle", "cable"], "question2": ["<Img><ImageHere></Img>Any defect?"]}
    kw = dict(max_new_tokens=8, cache_granularity=16, stop_single=5, stop_pair=(7, 9))
    greedy = model.generate(samples, **kw)["token_ids"]
    sampled = lambda seed, top_p: model.generate(samples, do_sample=True, top_p=top_p,
                                                 temperature=1.5, seed=seed, **kw)["token_ids"]
    torch.testing.assert_close(sampled(4, 0.9), sampled(4, 0.9), rtol=0, atol=0)
    assert not torch.equal(sampled(4, 0.9), greedy)
    torch.testing.assert_close(sampled(4, 1e-9), greedy, rtol=0, atol=0)


def test_engine_rejects_sampling(llama):
    """The serving engine is greedy-only, as the JAX engine (its constructor
    asserts ``not do_sample``)."""
    from myriad_tpu_torch.serving.engine import ServingEngine

    with pytest.raises(ValueError, match="greedy-only"):
        ServingEngine(llama, slots=2, bucket=64, config=GenerationConfig(do_sample=True))
    ServingEngine(llama, slots=2, bucket=64, config=GenerationConfig())
