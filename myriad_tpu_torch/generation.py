"""Greedy generation: chunked prefill + an eager decode loop (counterpart of
``myriad_tpu/generation.py``).

The multimodal prefix is prefilled into a preallocated KV cache, then the
decode loop emits tokens until every row has produced a stop sequence or
``max_new_tokens`` is reached.  Stop handling follows the reference
protocol: eos, '###' as the single id 835 or the pair (2277, 29937); rows
finish independently and finished rows emit ``pad_token_id``.  Only greedy
selection is ported; top-p sampling waits.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from myriad_tpu_torch.models.llama import LlamaForCausalLM, init_cache


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
            stopped = ((nxt == cfg.eos_token_id) | (nxt == cfg.stop_single)
                       | ((last == cfg.stop_pair[0]) & (nxt == cfg.stop_pair[1])))
            done = done | stopped
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
