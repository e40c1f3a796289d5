"""Greedy generation: chunked prefill + an eager decode loop (counterpart of
``myriad_tpu/generation.py``).

The multimodal prefix is prefilled into a preallocated KV cache, then the
decode loop emits tokens until every row has produced a stop sequence or
``max_new_tokens`` is reached.  Stop handling follows the reference
protocol: eos, '###' as the single id 835 or the pair (2277, 29937); rows
finish independently and finished rows emit ``pad_token_id``.  Only greedy
selection is ported; top-p sampling waits.

``continue_generate`` decodes from a cache that already holds a prompt
prefix (the resident-cache chat), and ``speculative_generate`` verifies
K drafted tokens per weight pass with per-row cache frontiers.  Only the
unstaged speculative loop is ported: the JAX package's staged spec spans
(``MYRIAD_SPEC_STAGED=1``) are a measurement knob, off by default.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from myriad_tpu_torch.models.llama import LlamaForCausalLM, init_cache, set_frontier


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 90
    eos_token_id: int = 2
    pad_token_id: int = 0
    stop_single: int = 835
    stop_pair: Tuple[int, int] = (2277, 29937)
    do_sample: bool = False
    top_p: float = 0.01
    temperature: float = 1.0
    # prefill as ceil(p/N)-token chunks plus a remainder chunk: exact for
    # any N and any prefix length (positions and causality are absolute)
    prefill_chunks: int = 1
    # KV-bucket rounding and staged-decode span width
    cache_granularity: int = 32
    # each decode span attends only over the cache prefix it can have
    # written (rounded up to cache_granularity); tokens are unchanged
    staged_decode: bool = False


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _chunk_count(p: int, want: int) -> int:
    """Prefill steps for a p-token prefix when ``want`` chunks are asked for:
    chunks are ceil(p/want) wide, so the count is ceil(p / ceil(p/want))."""
    want = max(int(want), 1)
    if want <= 1 or p <= 1:
        return 1
    csz = -(-p // min(want, p))
    return -(-p // csz)


def _prefill(model: LlamaForCausalLM, inputs_embeds: torch.Tensor, cache,
             n_chunks: int) -> torch.Tensor:
    """Fill the cache from the prefix; returns the last-position logits (B, 1, V)."""
    p = inputs_embeds.shape[1]
    if _chunk_count(p, n_chunks) <= 1:
        return model.prefill(inputs_embeds, cache)
    csz = -(-p // min(max(int(n_chunks), 1), p))
    last = None
    for s in range(0, p, csz):
        last = model.prefill(inputs_embeds[:, s:s + csz], cache)
    return last


def _select_token(logits: torch.Tensor, cfg: GenerationConfig) -> torch.Tensor:
    """logits (B, V) fp32 -> (B,) int64 greedy ids."""
    if cfg.do_sample:
        raise NotImplementedError("top-p sampling is not ported; greedy only")
    return torch.argmax(logits, dim=-1)


def _stopped(prev: torch.Tensor, nxt: torch.Tensor, cfg: GenerationConfig) -> torch.Tensor:
    """Rows whose next token ``nxt`` (after ``prev``) ends them: eos, the
    single '###' id, or the '###' pair."""
    return ((nxt == cfg.eos_token_id) | (nxt == cfg.stop_single)
            | ((prev == cfg.stop_pair[0]) & (nxt == cfg.stop_pair[1])))


def decode_stages(p: int, cfg: GenerationConfig) -> List[Tuple[int, int]]:
    """``(kv_limit, stage_end)`` spans of the decode loop: step s < stage_end
    attends over cache positions < kv_limit (its write frontier p + s stays
    below the limit by construction)."""
    max_len = _round_up(p + cfg.max_new_tokens, cfg.cache_granularity)
    if cfg.staged_decode:
        g = cfg.cache_granularity
        limits = list(range(_round_up(p + 2, g), max_len + 1, g)) or [max_len]
        limits[-1] = max_len
    else:
        limits = [max_len]
    return [(lim, min(lim - p, cfg.max_new_tokens - 1)) for lim in limits]


def _decode_loop(model: LlamaForCausalLM, cfg: GenerationConfig, last: torch.Tensor,
                 cache, stages: Sequence[Tuple[int, int]]) -> torch.Tensor:
    b = last.shape[0]
    tokens = torch.full((b, cfg.max_new_tokens), cfg.pad_token_id, dtype=torch.int64,
                        device=last.device)
    done = (last == cfg.eos_token_id) | (last == cfg.stop_single)
    step = 0
    for kv_limit, stage_end in stages:
        while step < stage_end and not bool(done.all()):
            tokens[:, step] = torch.where(done, cfg.pad_token_id, last)
            logits = model(model.embed(last[:, None]), cache, kv_limit=kv_limit)
            nxt = _select_token(logits[:, -1].float(), cfg)
            done = done | _stopped(last, nxt, cfg)
            last = nxt
            step += 1
    tokens[:, step] = torch.where(done, cfg.pad_token_id, last)
    return tokens


@torch.inference_mode()
def greedy_generate(model: LlamaForCausalLM, inputs_embeds: torch.Tensor, *,
                    config: Optional[GenerationConfig] = None,
                    cache_dtype=torch.bfloat16) -> torch.Tensor:
    """inputs_embeds (B, P, D) equal-length rows -> (B, max_new_tokens) token
    ids with ``pad_token_id`` after each row's stop."""
    cfg = config or GenerationConfig()
    b, p, _ = inputs_embeds.shape
    max_len = _round_up(p + cfg.max_new_tokens, cfg.cache_granularity)
    cache = init_cache(model.config, b, max_len, cache_dtype, inputs_embeds.device)
    logits = _prefill(model, inputs_embeds, cache, cfg.prefill_chunks)
    last = _select_token(logits[:, -1].float(), cfg)
    return _decode_loop(model, cfg, last, cache, decode_stages(p, cfg))


@torch.inference_mode()
def continue_generate(model: LlamaForCausalLM, new_embeds: torch.Tensor, cache, *,
                      config: Optional[GenerationConfig] = None,
                      valid_len: Optional[int] = None):
    """Generate from a cache that already holds earlier-prompt K/V.

    ``new_embeds`` (B, T_new, D) is prefilled at the cache's frontier
    (positions and causality follow the frontier, so this is token-exact
    against prefilling the whole prompt at once), then the unstaged decode
    loop runs.  ``valid_len`` marks only the first ``valid_len`` columns as
    the delta: the first token reads column valid_len - 1 and the frontier
    rewinds to start + valid_len.

    Returns ``(tokens, cache)``: the same cache buffers, mutated in place,
    with ``index`` set to the post-prefill frontier.  The decode loop's own
    writes stay in the slots past that frontier as scratch; they are
    position-masked (a slot is seen only by a query at or past it, and a
    query's own slot is written before it attends) until the next prefill
    or decode step overwrites them, so the next turn extends the prompt from
    the returned frontier exactly as from the JAX package's functional
    post-prefill cache.  The caller sizes the cache: frontier + T_new +
    max_new_tokens must fit it.
    """
    cfg = config or GenerationConfig()
    if cache[0]["k"].shape[0] != new_embeds.shape[0]:
        raise ValueError("cache batch mismatch")
    if valid_len is not None:
        if _chunk_count(new_embeds.shape[1], cfg.prefill_chunks) != 1:
            raise ValueError("valid_len needs a single-chunk prefill")
        start = cache[0]["index"]
        logits = model.prefill(new_embeds, cache, last_index=int(valid_len) - 1)
        set_frontier(cache, start + int(valid_len))
    else:
        logits = _prefill(model, new_embeds, cache, cfg.prefill_chunks)
    frontier = cache[0]["index"]
    last = _select_token(logits[:, -1].float(), cfg)
    tokens = _decode_loop(model, cfg, last, cache, [(None, cfg.max_new_tokens - 1)])
    set_frontier(cache, frontier)
    return tokens, cache


def _lookup_drafts(corpus: torch.Tensor, prev: torch.Tensor, last: torch.Tensor,
                   cur: torch.Tensor, k: int) -> torch.Tensor:
    """Prompt-lookup drafts: the K tokens that followed the most recent
    (prev, last) 2-gram in each row's corpus (its first ``cur`` entries),
    else the most recent ``last`` 1-gram."""
    b, n = corpus.shape
    pos = torch.arange(n, device=corpus.device)[None, :]
    nxt = torch.cat([corpus[:, 1:], torch.full((b, 1), -2, dtype=corpus.dtype,
                                               device=corpus.device)], dim=1)
    m2 = (corpus == prev[:, None]) & (nxt == last[:, None]) & (pos + 1 < cur[:, None])
    m1 = (corpus == last[:, None]) & (pos < cur[:, None])
    none = torch.tensor(-1, device=corpus.device)
    j2 = torch.where(m2, pos, none).amax(dim=1)
    j1 = torch.where(m1, pos, none).amax(dim=1)
    first = torch.where(j2 >= 0, j2 + 2, j1 + 1)
    idx = (first[:, None] + torch.arange(k, device=corpus.device)[None, :]).clamp(0, n - 1)
    return corpus.gather(1, idx)


def _emit_window(chain: torch.Tensor, a: torch.Tensor, done: torch.Tensor,
                 cfg: GenerationConfig):
    """A verify round's output: ``chain`` (B, K+2) is the fed token and the
    model's K+1 greedy tokens, ``a`` the accepted drafts.  Emits chain[0..a]
    on rows not ``done``, with greedy_generate's stop rules, as a (B, K+1)
    window padded with ``pad_token_id``; returns (window, done after the
    window, tokens emitted)."""
    b, k1 = chain.shape[0], chain.shape[1] - 1
    window = torch.full((b, k1), cfg.pad_token_id, dtype=torch.int64, device=chain.device)
    done_j = done
    n_new = torch.zeros((b,), dtype=torch.int64, device=chain.device)
    for j in range(k1):
        c_j, c_n = chain[:, j], chain[:, j + 1]
        valid = (j <= a) & ~done_j
        window[:, j] = torch.where(valid, c_j, cfg.pad_token_id)
        done_j = done_j | (valid & _stopped(c_j, c_n, cfg))
        n_new = n_new + valid.long()
    return window, done_j, n_new


@torch.inference_mode()
def speculative_generate(model: LlamaForCausalLM, inputs_embeds: torch.Tensor, *,
                         config: Optional[GenerationConfig] = None, spec_k: int = 4,
                         lookup_ids=None, oracle_drafts=None, cache_dtype=torch.bfloat16,
                         return_stats: bool = False, cache=None,
                         valid_len: Optional[int] = None, return_cache: bool = False):
    """Greedy generation with self-speculative decoding, transcript-exact.

    Each round feeds the row's last token and ``spec_k`` drafted tokens as one
    (B, K+1) verify chunk (kernels B1, B3 and B4 on the card), takes the
    model's own greedy tokens, and accepts the leading drafts that match
    them: every emitted token is a verified greedy argmax, so the output
    equals ``greedy_generate``'s.  Rows accept independently: the cache
    carries per-row frontiers, and a rolled-back row's stale slots are
    overwritten before any query can see them.

    Drafts come from a 2-gram (else 1-gram) lookup over ``lookup_ids`` (a
    prompt corpus, (L,) or (B, L)) followed by the row's own tokens, or
    from ``oracle_drafts`` (B, >= max_new_tokens), which tests use to pin
    the acceptance.  Drafts outside the vocabulary are clamped into it.

    ``return_stats`` adds a dict of ints: ``accepted`` (verified drafts over
    active rows), ``drafted`` (drafts proposed over active rows) and
    ``rounds`` (verify passes).  Continuation mode (the resident-cache
    chat): ``cache`` holds earlier-prompt K/V and ``inputs_embeds`` is the
    new delta (with ``valid_len`` as in ``continue_generate``);
    ``return_cache`` adds the cache, its ``index`` set to the post-prefill
    frontier.  The caller's cache must hold frontier + T_new + max_new +
    spec_k + 1 positions.
    """
    cfg = config or GenerationConfig()
    if cfg.do_sample:
        raise ValueError("speculative decoding is greedy-only")
    k = int(spec_k)
    if k < 1:
        raise ValueError(f"spec_k must be >= 1, got {spec_k}")
    b, t_in, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    max_new = cfg.max_new_tokens

    if cache is None:
        max_len = _round_up(t_in + max_new + k + 1, cfg.cache_granularity)
        cache = init_cache(model.config, b, max_len, cache_dtype, dev)
        logits = _prefill(model, inputs_embeds, cache, cfg.prefill_chunks)
        start = t_in
    else:
        if cache[0]["k"].shape[0] != b:
            raise ValueError("cache batch mismatch")
        start0 = cache[0]["index"]
        if valid_len is not None:
            if _chunk_count(t_in, cfg.prefill_chunks) != 1:
                raise ValueError("valid_len needs a single-chunk prefill")
            logits = model.prefill(inputs_embeds, cache, last_index=int(valid_len) - 1)
            start = start0 + int(valid_len)
        else:
            logits = _prefill(model, inputs_embeds, cache, cfg.prefill_chunks)
            start = start0 + t_in
    prompt_frontier = start
    last = torch.argmax(logits[:, -1].float(), dim=-1)
    # per-row frontiers from here on (ragged acceptance)
    length = torch.full((b,), start, dtype=torch.int32, device=dev)
    set_frontier(cache, length)

    tokens = torch.full((b, max_new + k + 1), cfg.pad_token_id, dtype=torch.int64, device=dev)
    if lookup_ids is not None:
        lookup_ids = torch.as_tensor(lookup_ids, dtype=torch.int64, device=dev)
        lookup_ids = lookup_ids.reshape(-1, lookup_ids.shape[-1]).expand(b, -1)
    lp = 0 if lookup_ids is None else lookup_ids.shape[1]
    if oracle_drafts is not None:
        oracle_drafts = torch.nn.functional.pad(
            torch.as_tensor(oracle_drafts, dtype=torch.int64, device=dev), (0, k + 1))
    arange_k = torch.arange(k, device=dev)
    cols = torch.arange(k + 1, device=dev)

    n_emit = torch.zeros((b,), dtype=torch.int64, device=dev)
    prev = torch.full((b,), -1, dtype=torch.int64, device=dev)
    done = (last == cfg.eos_token_id) | (last == cfg.stop_single)
    accepted = torch.zeros((), dtype=torch.int64, device=dev)
    drafted = torch.zeros((), dtype=torch.int64, device=dev)
    rounds = 0
    while not bool(done.all()):
        if oracle_drafts is not None:
            # ``last`` is output token n_emit, so drafts continue at n_emit + 1
            idx = ((n_emit + 1)[:, None] + arange_k[None, :]).clamp(
                max=oracle_drafts.shape[1] - 1)
            draft = oracle_drafts.gather(1, idx)
        else:
            corpus = tokens if lookup_ids is None else torch.cat([lookup_ids, tokens], dim=1)
            draft = _lookup_drafts(corpus, prev, last, n_emit + lp, k)
        draft = draft.clamp(0, model.config.vocab_size - 1)
        feed = torch.cat([last[:, None], draft], dim=1)                  # (B, K+1)
        logits = model(model.embed(feed), cache)                         # writes at length
        g = torch.argmax(logits.float(), dim=-1)                         # (B, K+1)
        chain = torch.cat([last[:, None], g], dim=1)                     # (B, K+2)
        a = torch.cumprod((feed[:, 1:] == g[:, :-1]).long(), dim=1).sum(dim=1)

        window, done_j, n_new = _emit_window(chain, a, done, cfg)
        # rows already done park their all-pad window in the slack past max_new
        offset = torch.where(done, max_new, n_emit.clamp(max=max_new - 1))
        tokens.scatter_(1, offset[:, None] + cols[None, :], window)

        active = (~done).long()
        accepted = accepted + (a * active).sum()
        drafted = drafted + k * active.sum()
        rounds += 1
        n_emit = n_emit + n_new
        length = length + (a + 1).to(torch.int32)
        done = done_j | (n_emit >= max_new)
        last = chain.gather(1, (a + 1)[:, None])[:, 0]
        prev = chain.gather(1, a[:, None])[:, 0]
        # the verify pass advanced every frontier by K+1: keep the accepted part
        set_frontier(cache, length)

    out = tokens[:, :max_new]
    if return_stats:
        out = (out, {"accepted": int(accepted), "drafted": int(drafted), "rounds": rounds})
    if return_cache:
        set_frontier(cache, prompt_frontier)
        return out, cache
    return out


def trim_stop_ids(row, cfg: Optional[GenerationConfig] = None) -> List[int]:
    """Trim one generated row at eos/'###'/pad, returning the kept ids."""
    cfg = cfg or GenerationConfig()
    ids: List[int] = []
    prev = None
    for t in np.asarray(row).tolist():
        if t in (cfg.eos_token_id, cfg.stop_single, cfg.pad_token_id):
            break
        if prev == cfg.stop_pair[0] and t == cfg.stop_pair[1]:
            ids.pop()
            break
        ids.append(t)
        prev = t
    return ids
