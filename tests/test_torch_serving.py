"""The port's continuous-batching engine (myriad_tpu_torch/serving/engine.py)
against the JAX package's ``ServingEngine``, on the CPU, at
``LlamaConfig.tiny`` with the same random weights on both sides (fp32 policy,
weights through ``convert_from_jax``).

Each scenario runs one submit/step schedule through both engines in lock
step (``Twin``).  Gates, tolerance 0 (token ids and counts): at every tick
the ``Finished`` records (request id, tokens, raw tokens, prompt length,
held) are equal; at the end the ``stats`` counters are equal; and every
transcript equals the port's own solo ``greedy_generate`` of the request
(for a held conversation, of its whole history).  The scenarios mirror
tests/test_serving_engine.py; its program-count and block-layout tests have
no counterpart (the port compiles no programs and has no block layout).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myriad_tpu.generation import GenerationConfig as JaxGenerationConfig
from myriad_tpu.serving import ServingEngine as JaxEngine
from myriad_tpu_torch import generation as gen
from myriad_tpu_torch.serving import Finished, ServingEngine
from test_torch_llama import _models
import torch_threads  # noqa: F401  (one torch thread a test process)

NO_STOP = dict(eos_token_id=-1, stop_single=-1, stop_pair=(-1, -1))
CFG = dict(max_new_tokens=10, **NO_STOP)
STATS = ("submitted", "completed", "ticks", "decode_steps", "live_row_steps",
         "spec_accepted", "spec_drafted")


@pytest.fixture(scope="module")
def tiny():
    jmodel, params, tmodel = _models("bf16", "bf16", seed=3)
    return jmodel, params, tmodel


def _prompts(rng, lengths, dim=64):
    return [(rng.normal(size=(t, dim)) * 0.15).astype(np.float32) for t in lengths]


def _cache_dtypes(kind):
    return (jnp.float32, torch.float32) if kind == "fp32" else ("int8", "int8")


# compiled JAX engine programs, shared by the scenarios whose engines they fit:
# every jitted program is a function of its inputs and of the configuration in
# its key, so a second engine reuses the first one's compiles
_JAX_PROGRAMS = {}


def share_jax_programs(eng):
    """Give a JAX engine the programs an earlier engine of its configuration
    compiled; ``keep_jax_programs`` stores the ones it compiles itself."""
    key = (repr(eng.cfg), repr(eng.cache_dtype))
    eng._prefill_progs = _JAX_PROGRAMS.setdefault(("prefill",) + key, {})
    eng._cont_progs = _JAX_PROGRAMS.setdefault(("cont",) + key, {})
    eng._insert_prog = _JAX_PROGRAMS.get(_insert_key(eng))
    eng._segment_prog = _JAX_PROGRAMS.get(_segment_key(eng))


def keep_jax_programs(eng):
    for key, prog in ((_insert_key(eng), eng._insert_prog),
                      (_segment_key(eng), eng._segment_prog)):
        if prog is not None:
            _JAX_PROGRAMS.setdefault(key, prog)


def _insert_key(eng):
    return ("insert", repr(eng.cfg), eng.spec_k)


def _segment_key(eng):
    lookup = None if eng._lookup_ids is None else eng._lookup_ids.tobytes()
    return ("segment", repr(eng.cfg), repr(eng.cache_dtype), eng.segment, eng.spec_k, lookup)


def _solo(tmodel, x, cfg, cache_dtype):
    """The port's solo greedy_generate of one prompt, trimmed as the engine trims."""
    out = gen.greedy_generate(tmodel, torch.from_numpy(x)[None], config=cfg,
                              cache_dtype=cache_dtype)[0].numpy()
    return np.asarray(gen.trim_stop_ids(out, cfg), np.int32)


def _embed(tmodel, ids):
    with torch.inference_mode():
        return tmodel.embed(torch.as_tensor(np.asarray(ids), dtype=torch.int64)).numpy()


class Twin:
    """The JAX engine and the port's, driven by one schedule in lock step."""

    def __init__(self, tiny, *, cfg=None, cache="fp32", **kw):
        jmodel, params, tmodel = tiny
        cfg = cfg or CFG
        jdt, tdt = _cache_dtypes(cache)
        self.tmodel, self.tdt = tmodel, tdt
        self.tcfg = gen.GenerationConfig(**cfg)
        self.j = JaxEngine(jmodel, params, config=JaxGenerationConfig(**cfg), cache_dtype=jdt,
                           **kw)
        share_jax_programs(self.j)
        self.t = ServingEngine(tmodel, config=self.tcfg, cache_dtype=tdt, **kw)
        self.results = {}
        self.ticks = 0

    def submit(self, x, **kw):
        rid = self.j.submit(jnp.asarray(x), **kw)
        assert self.t.submit(torch.from_numpy(x), **kw) == rid
        return rid

    def continue_request(self, handle, x, **kw):
        rid = self.j.continue_request(handle, jnp.asarray(x), **kw)
        assert self.t.continue_request(handle, torch.from_numpy(x), **kw) == rid
        return rid

    def release(self, handle):
        self.j.release(handle)
        self.t.release(handle)

    def step(self):
        want, got = self.j.step(), self.t.step()
        keep_jax_programs(self.j)
        self.ticks += 1
        assert self.ticks < 200
        assert [f.request_id for f in got] == [f.request_id for f in want], self.ticks
        for f, w in zip(got, want):
            assert isinstance(f, Finished)
            np.testing.assert_array_equal(f.tokens, np.asarray(w.tokens), err_msg=str(f))
            np.testing.assert_array_equal(f.raw_tokens, np.asarray(w.raw_tokens))
            assert (f.n_prompt, f.held) == (w.n_prompt, w.held)
            assert f.tokens.dtype == np.int32 and f.raw_tokens.dtype == np.int32
            self.results[f.request_id] = f
        return got

    @property
    def pending(self):
        assert self.t.pending == self.j.pending
        return self.t.pending

    def drain(self):
        out = []
        while self.pending:
            out.extend(self.step())
        return out

    def check_stats(self):
        assert {k: self.t.stats[k] for k in STATS} == {k: self.j.stats[k] for k in STATS}
        assert self.t.stats["decode_wall_s"] >= 0 and self.t.stats["admit_wall_s"] >= 0

    def solo(self, x):
        return _solo(self.tmodel, x, self.tcfg, self.tdt)


@pytest.mark.parametrize("cache", ["fp32", "int8"])
def test_staggered_arrivals_match_jax(tiny, cache):
    """Six requests over two slots, two arrivals a tick, short after long in
    a dirty slot: the stale K/V of the previous tenant is never seen."""
    tw = Twin(tiny, cache=cache, slots=2, bucket=64, segment=3, admit_widths=(8, 16))
    prompts = _prompts(np.random.default_rng(0), [13, 5, 9, 3, 11, 7])
    arrivals = list(enumerate(prompts))
    while arrivals or tw.pending:
        for _ in range(2):
            if arrivals:
                i, p = arrivals.pop(0)
                tw.submit(p, request_id=i)
        tw.step()
    tw.check_stats()
    assert sorted(tw.results) == list(range(6))
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(tw.results[i].tokens, tw.solo(p), err_msg=f"request {i}")


def test_admission_while_decoding_matches_jax(tiny):
    tw = Twin(tiny, slots=2, bucket=64, segment=3, admit_widths=(16,))
    a, b = _prompts(np.random.default_rng(7), [10, 4])
    tw.submit(a, request_id=0)
    tw.step()  # a is mid-decode (3 of 10 tokens)
    tw.submit(b, request_id=1)
    tw.drain()
    tw.check_stats()
    for i, p in enumerate((a, b)):
        np.testing.assert_array_equal(tw.results[i].tokens, tw.solo(p))


def _stop_cfg(tiny, prompt, new, at):
    """A config whose stop_single is the ``at``-th token of the prompt's
    greedy stream, so that the row stops early."""
    probe = _solo(tiny[2], prompt, gen.GenerationConfig(max_new_tokens=new, **NO_STOP),
                  torch.float32)
    return dict(max_new_tokens=new, eos_token_id=-1, stop_single=int(probe[at]),
                stop_pair=(-1, -1))


def test_stop_token_rows_finish_on_their_own_match_jax(tiny):
    prompts = _prompts(np.random.default_rng(3), [6, 8, 7])
    cfg = _stop_cfg(tiny, prompts[0], 6, 2)
    tw = Twin(tiny, cfg=cfg, slots=3, bucket=64, segment=8, admit_widths=(8,))
    for i, p in enumerate(prompts):
        tw.submit(p, request_id=i)
    tw.drain()
    tw.check_stats()
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(tw.results[i].tokens, tw.solo(p))
    assert len(tw.results[0].tokens) < cfg["max_new_tokens"]


@pytest.mark.parametrize("with_lookup", [False, True])
def test_spec_engine_matches_jax(tiny, with_lookup):
    """spec_k = 3: the same rounds, acceptance and transcripts as the JAX
    engine, and the solo greedy transcripts; with the expected outputs as
    the lookup corpus the drafts are accepted."""
    prompts = _prompts(np.random.default_rng(9), [9, 5, 12, 3])
    refs = [_solo(tiny[2], p, gen.GenerationConfig(**CFG), torch.float32) for p in prompts]
    lookup = np.concatenate(refs) if with_lookup else None
    tw = Twin(tiny, slots=2, bucket=64, segment=3, admit_widths=(8, 16), spec_k=3,
              lookup_ids=lookup)
    for i, p in enumerate(prompts):
        tw.submit(p, request_id=i)
    tw.drain()
    tw.check_stats()
    for i, ref in enumerate(refs):
        np.testing.assert_array_equal(tw.results[i].tokens, ref, err_msg=f"request {i}")
    assert tw.t.stats["spec_drafted"] > 0
    if with_lookup:
        assert tw.t.stats["spec_accepted"] > 0


def test_spec_slot_reuse_and_stops_match_jax(tiny):
    prompts = _prompts(np.random.default_rng(13), [11, 4, 7])
    cfg = _stop_cfg(tiny, prompts[0], 8, 3)
    tw = Twin(tiny, cfg=cfg, slots=1, bucket=64, segment=4, admit_widths=(16,), spec_k=2)
    for i, p in enumerate(prompts):
        tw.submit(p, request_id=i)
    tw.drain()
    tw.check_stats()
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(tw.results[i].tokens, tw.solo(p))
    assert len(tw.results[0].tokens) < cfg["max_new_tokens"]


def test_spec_stop_inside_accepted_window_matches_jax(tiny):
    """A stop inside an accepted draft window leaves the frontier at the
    emitted end: the held slot's next turn equals the full-history greedy."""
    tmodel = tiny[2]
    for seed in range(33, 65):
        p1, p2 = _prompts(np.random.default_rng(seed), [9, 5])
        probe = _solo(tmodel, p1, gen.GenerationConfig(**CFG), torch.float32)
        if probe[0] not in probe[1:6] and len(set(probe[:3].tolist())) == 3:
            break
    else:
        pytest.fail("no seed produced a non-repeating greedy opening")
    cfg = dict(max_new_tokens=8, eos_token_id=-1, stop_single=int(probe[1]), stop_pair=(-1, -1))
    tw = Twin(tiny, cfg=cfg, slots=1, bucket=64, segment=4, admit_widths=(8, 16), spec_k=3,
              lookup_ids=probe)
    h = tw.submit(p1, hold=True)
    (f1,) = tw.drain()
    np.testing.assert_array_equal(f1.raw_tokens, probe[:1])  # stopped after one token
    assert tw.t.stats["spec_accepted"] > 0  # the window ran past the stop
    tw.continue_request(h, p2)
    (f2,) = tw.drain()
    tw.check_stats()
    full = np.concatenate([p1, _embed(tmodel, f1.raw_tokens), p2])
    np.testing.assert_array_equal(f2.tokens, tw.solo(full))


@pytest.mark.parametrize("spec_k", [0, 2])
def test_hold_and_continue_three_turns_match_jax(tiny, spec_k):
    """Held conversations over three turns, each turn's delta prefilled in
    place while an unrelated request decodes beside it; every turn equals a
    greedy run over the whole history; release frees the slot."""
    tmodel = tiny[2]
    rng = np.random.default_rng(21)
    p1, p2, other = _prompts(rng, [7, 5, 12])
    tw = Twin(tiny, slots=2, bucket=64, segment=3, admit_widths=(8, 16), spec_k=spec_k)
    h = tw.submit(p1, hold=True)
    (f1,) = tw.drain()
    assert f1.held and f1.request_id == h
    np.testing.assert_array_equal(f1.tokens, tw.solo(p1))

    rid_other = tw.submit(other)
    tw.step()
    rid2 = tw.continue_request(h, p2, hold=True)
    tw.drain()
    full = np.concatenate([p1, _embed(tmodel, f1.raw_tokens), p2])
    np.testing.assert_array_equal(tw.results[rid2].tokens, tw.solo(full))
    np.testing.assert_array_equal(tw.results[rid_other].tokens, tw.solo(other))

    p3 = _prompts(rng, [4])[0]
    rid3 = tw.continue_request(rid2, p3, hold=True)
    (f3,) = tw.drain()
    full3 = np.concatenate([full, _embed(tmodel, tw.results[rid2].raw_tokens), p3])
    np.testing.assert_array_equal(f3.tokens, tw.solo(full3))
    assert f3.held and tw.t._frontier_host[tw.t._held[rid3]] == len(full3) + len(f3.raw_tokens)
    tw.release(rid3)
    with pytest.raises(KeyError):
        tw.t.continue_request(999, p2)
    for i, p in enumerate(_prompts(rng, [6, 9])):  # both slots free again
        tw.submit(p, request_id=100 + i)
    got = {f.request_id for f in tw.drain()}
    assert got == {100, 101}
    tw.check_stats()


def test_submit_group_spill_to_host_and_solo_greedy(tiny):
    """Group submission: past max_queued_device_bytes the tail groups move to
    the host and upload again at admission; the transcripts equal the solo
    greedy runs."""
    tmodel = tiny[2]
    lengths = [5, 7, 3, 6, 4, 8]
    prompts = _prompts(np.random.default_rng(7), lengths)
    width, dim = 8, 64
    cfg = gen.GenerationConfig(**CFG)

    def group(idx):
        arr = torch.zeros((len(idx), width, dim))
        for j, i in enumerate(idx):
            arr[j, :lengths[i]] = torch.from_numpy(prompts[i])
        return arr, np.asarray([lengths[i] for i in idx])

    eng = ServingEngine(tmodel, slots=2, bucket=64, config=cfg, cache_dtype=torch.float32,
                        segment=4, admit_widths=(8, 16),
                        max_queued_device_bytes=2 * width * dim * 4)
    rids = []
    for idx in ([0, 1], [2, 3], [4, 5]):
        rids += eng.submit_group(*group(idx))
    assert [b.host for b in eng._queue] == [False, True, True]
    assert eng.queued_rows == 6 and eng.free_slot_count == 2
    results = {f.request_id: f.tokens for f in eng.drain()}
    assert sorted(results) == rids
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(results[rid], _solo(tmodel, p, cfg, torch.float32))
    assert eng.stats["completed"] == 6


def test_validation_errors(tiny):
    tmodel = tiny[2]
    cfg = gen.GenerationConfig(**CFG)
    dim = 64
    with pytest.raises(NotImplementedError, match="block KV layout is not ported"):
        ServingEngine(tmodel, slots=4, config=cfg, block_size=2)
    with pytest.raises(ValueError, match="greedy-only"):
        ServingEngine(tmodel, config=gen.GenerationConfig(do_sample=True))
    with pytest.raises(ValueError, match="no admission width"):
        ServingEngine(tmodel, bucket=32, admit_widths=(64,))
    eng = ServingEngine(tmodel, slots=1, bucket=32, config=cfg, cache_dtype=torch.float32,
                        admit_widths=(8, 16, 64))
    assert eng.admit_widths == (8, 16)  # widths above the bucket are dropped
    with pytest.raises(ValueError, match="does not fit"):  # prompt + max_new over the bucket
        eng.submit(np.zeros((30, dim), np.float32))
    with pytest.raises(ValueError, match="largest admission width"):
        eng.submit(np.zeros((20, dim), np.float32))
    with pytest.raises(ValueError, match="one .T, D. prompt"):
        eng.submit(np.zeros((1, 4, dim), np.float32))
    with pytest.raises(ValueError, match="not on the admission ladder"):
        eng.submit_group(torch.zeros((1, 12, dim)), 4)
    with pytest.raises(ValueError, match=r"valid lengths must lie in \[1, width=8\]"):
        eng.submit_group(torch.zeros((1, 8, dim)), np.asarray([9]))
    with pytest.raises(ValueError, match=r"valid lengths"):
        eng.submit_group(torch.zeros((2, 8, dim)), np.asarray([4, 0]))
    with pytest.raises(ValueError, match="reserved ids"):
        eng.submit_group(torch.zeros((2, 8, dim)), 4, request_ids=[1])
    assert eng.step() == [] and eng.stats["ticks"] == 0  # an empty tick is a no-op

    # continue_request's two capacity bounds, the lease kept on rejection
    eng = ServingEngine(tmodel, slots=1, bucket=48, config=cfg, cache_dtype=torch.float32,
                        segment=16, admit_widths=(8, 16))
    h = eng.submit(np.zeros((16, dim), np.float32) + 0.1, hold=True)
    (f,) = eng.drain()
    assert f.held and eng._frontier_host[0] == 16 + len(f.raw_tokens) == 26
    with pytest.raises(ValueError, match="overflows"):  # 26 + 12 + 10 + 1 > 48
        eng.continue_request(h, np.zeros((12, dim), np.float32))
    with pytest.raises(ValueError, match="largest admission width"):
        eng.continue_request(h, np.zeros((17, dim), np.float32))
    assert eng._held == {h: 0} and eng.free_slot_count == 0
    rid = eng.continue_request(h, np.zeros((5, dim), np.float32))  # 26 + 5 + 11 <= 48
    (f2,) = eng.drain()
    assert f2.request_id == rid and not f2.held and eng.free_slot_count == 1
    with pytest.raises(RuntimeError, match="set_lookup"):
        eng.set_lookup([1, 2])
