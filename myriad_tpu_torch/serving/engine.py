"""Continuous-batching serving engine: a fixed slot pool with per-row KV
frontiers and segment decode (counterpart of ``myriad_tpu/serving/engine.py``).

A pool of ``slots`` KV-cache rows shares one preallocated cache of
``bucket`` positions a row.  Requests are admitted into free rows as they
arrive; one decode segment advances every occupied row, each with its own
write frontier, stop state and output offset; a finished row frees its slot
at once and the next pending request takes it over.

- **Per-row frontiers.**  The cache's ``index`` is a ``(slots,)`` int32
  tensor from the start.  A decode step writes each row's K/V at its own
  frontier (kernel B4's per-row starts) and attends over the whole bucket
  through the additive mask over absolute positions (kernel B2): slot ``p``
  is seen by a query at position ``q`` iff ``p <= q``.  A freed slot's stale
  K/V therefore lies at positions the next tenant's queries never admit
  until they have overwritten them, so slot reuse needs no invalidation.
- **Admission** groups requests by the smallest admission width that holds
  them and prefills each power-of-two chunk (at most ``max_admit_chunk``
  rows) into a fresh mini cache of ``width`` positions, right-padded; each
  row's first token is read at column ``valid - 1``, and the chunk is
  grafted into its slots (every cache leaf, by ``index_copy_``) with the
  frontiers rewound to ``valid``.  The pad K/V past ``valid`` is
  overwritten by decode before the mask admits it.
- **Segment decode** is an eager loop of up to ``segment`` steps that stops
  when every row is done.  Active rows emit ``last`` at their own offsets;
  done and free rows park a pad in the slack column and rewrite their own
  frontier slot with junk the mask excludes; frontiers advance only for
  active rows.  ``spec_k > 0`` turns each step into a verify round
  (``generation.speculative_generate``'s drafting, acceptance and emit
  window), gated on each row's active flag.
- **Held conversations** keep a finished row's K/V resident;
  ``continue_request`` prefills the next turn's delta in place at the
  row's frontier (``generation.continue_generate``'s exactness argument).

Token streams equal ``generation.greedy_generate`` run per request and the
JAX engine's, decision for decision (``stats`` included), for the same
schedule (tests/test_torch_serving.py).  The engine is greedy-only, as the
JAX one is.

Across ranks (``mesh=``, a ``parallel.mesh.Mesh`` of n_model > 1, as the
JAX engine's ``mesh`` shards its pool over heads): the model is this rank's
shard (a whole model given with the mesh is sharded here), the KV pool and
its int8 per-position scales hold the rank's heads, and kernel B4 writes
each row in place on them.  Slot and state vectors are whole on every rank,
and every scheduling decision is taken from bits that are equal on every
rank (the gathered logits' argmax, the prompts' lengths, the queue), never
from a clock: the ranks run one schedule in lock step.

Not ported: the JAX engine's block KV layout (``block_size > 0``) and
donation.  The block layout exists because XLA rewrites the whole pool on a
per-row write; kernel B4 writes per row in place.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from myriad_tpu_torch.generation import (GenerationConfig, _emit_window, _lookup_drafts,
                                         _stopped, trim_stop_ids)
from myriad_tpu_torch.models.llama import LlamaForCausalLM, init_cache, set_frontier


@dataclasses.dataclass
class Finished:
    """A completed request: trimmed token ids (stop/eos/pad removed).

    ``raw_tokens`` is the untrimmed emitted stream (every token whose K/V was
    written): a held conversation's next turn continues after these, so the
    caller composing the next delta accounts for them, not for the trimmed
    text.  ``held`` marks a slot kept resident for ``continue_request``."""

    request_id: int
    tokens: np.ndarray  # (n,) int32, n <= max_new_tokens
    n_prompt: int
    raw_tokens: Optional[np.ndarray] = None
    held: bool = False


@dataclasses.dataclass
class _Pending:
    request_id: int
    embeds: torch.Tensor  # (T, D)
    hold: bool = False


@dataclasses.dataclass
class _PendingBatch:
    """A same-width group queued as one tensor, on the engine's device from
    the embed forward to the admission prefill, or on the host (``host``)
    once ``submit_group`` spilled it past ``max_queued_device_bytes``."""

    request_ids: List[int]
    embeds: torch.Tensor  # (n, width, D), width on the admission ladder
    valid: np.ndarray     # (n,) true prompt lengths
    hold: bool = False
    host: bool = False

    def split(self, take: int) -> Tuple["_PendingBatch", "_PendingBatch"]:
        return (
            _PendingBatch(self.request_ids[:take], self.embeds[:take], self.valid[:take],
                          self.hold, self.host),
            _PendingBatch(self.request_ids[take:], self.embeds[take:], self.valid[take:],
                          self.hold, self.host),
        )


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _chunks(total: int, cap: int) -> List[Tuple[int, int]]:
    """(start, n) admission chunks: the largest power of two left, at most ``cap``."""
    out, i = [], 0
    while i < total:
        n = min(1 << (total - i).bit_length() - 1, cap)
        out.append((i, n))
        i += n
    return out


class ServingEngine:
    """Continuous-batching decode over a fixed slot pool.

    Args:
      model: a ``LlamaForCausalLM``; the engine runs on its device.
      slots: KV rows decoded together (the engine's concurrency).
      bucket: per-slot KV capacity; every request needs
        ``prompt_len + max_new_tokens + 2 * spec_k + 1 <= bucket`` (the
        slack rationale is in ``submit``).
      config: ``GenerationConfig`` (stop ids, max_new_tokens); greedy only.
      cache_dtype: KV dtype (``torch.bfloat16``, ``torch.float32`` or "int8").
      segment: decode steps (verify rounds when ``spec_k > 0``) per tick.
      admit_widths: admission padding ladder (widths above ``bucket`` are
        dropped); a prompt admits at the smallest width that holds it.
      max_admit_chunk: cap on the requests prefilled in one admission chunk.
      spec_k / lookup_ids: speculative verify rounds of ``spec_k`` drafts,
        from the shared ``lookup_ids`` corpus and each row's own output.
      max_queued_device_bytes: cap on the prompt bytes the queue holds on
        the device (see ``submit_group``).
      block_size: must be 0: the JAX engine's block KV layout is not ported.
      mesh: serve across the mesh's model group: ``model`` is a shard built
        with this mesh, or a whole model, which is sharded here.
    """

    def __init__(
        self,
        model: LlamaForCausalLM,
        *,
        slots: int = 8,
        bucket: int = 512,
        config: Optional[GenerationConfig] = None,
        cache_dtype=torch.bfloat16,
        segment: int = 32,
        admit_widths: Tuple[int, ...] = (64, 128, 256, 512),
        max_admit_chunk: int = 16,
        spec_k: int = 0,
        lookup_ids=None,
        max_queued_device_bytes: int = 512 << 20,
        block_size: int = 0,
        mesh=None,
    ):
        if block_size:
            raise NotImplementedError(
                f"block_size={block_size}: the block KV layout is not ported.  It exists "
                "because XLA rewrites the whole pool on a per-row cache write; kernel B4 "
                "writes per row in place, so the port serves per-row frontiers "
                "(block_size=0)")
        if mesh is not None and mesh.sharded:
            if getattr(model, "mesh", None) is None:
                model = model.sharded(mesh)
            elif model.mesh is not mesh:
                raise ValueError("the model is a shard of another mesh")
        self.model = model
        self.mesh = getattr(model, "mesh", None)
        self.device = model.lm_head.device
        self.slots = int(slots)
        self.bucket = int(bucket)
        self.cfg = config or GenerationConfig()
        if self.cfg.do_sample:
            raise ValueError("the serving engine is greedy-only: sampled transcripts would "
                             "depend on co-residency and segment size")
        self.cache_dtype = cache_dtype
        self.segment = int(segment)
        self.spec_k = int(spec_k)
        self._lookup_ids = (None if lookup_ids is None
                            else np.asarray(lookup_ids, np.int64).reshape(-1))
        self.admit_widths = tuple(sorted(w for w in admit_widths if w <= self.bucket))
        if not self.admit_widths:
            raise ValueError(f"no admission width of {tuple(admit_widths)} fits the "
                             f"{self.bucket}-position bucket")
        self.max_admit_chunk = max(1, int(max_admit_chunk))
        self.max_queued_device_bytes = int(max_queued_device_bytes)

        self._queue: List[Union[_Pending, _PendingBatch]] = []
        self._slot_req: List[Optional[int]] = [None] * self.slots
        self._slot_prompt_len: List[int] = [0] * self.slots
        self._slot_hold: List[bool] = [False] * self.slots
        self._slot_want_hold: List[bool] = [False] * self.slots
        self._held: Dict[int, int] = {}  # finished handle -> resident slot
        self._cont_queue: List[Tuple[int, _Pending]] = []  # (slot, delta)
        # host copy of the frontiers, refreshed each tick: continue_request's
        # capacity checks need no device read of their own
        self._frontier_host = np.zeros((self.slots,), np.int64)
        self._next_id = 0
        # live_row_steps / (decode_steps * slots) = slot occupancy (decode_steps
        # counts verify rounds when spec_k > 0); spec_accepted / spec_drafted =
        # draft acceptance
        self.stats = {"submitted": 0, "completed": 0, "ticks": 0, "decode_steps": 0,
                      "live_row_steps": 0, "spec_accepted": 0, "spec_drafted": 0}
        # profiling only: synchronize at the admit/decode boundary in step() so
        # admit_wall_s and decode_wall_s split device time, not launch time
        self.profile_sync = False
        # the decode segment, chosen at the first tick; set_lookup must come first
        self._segment_prog = None
        self._state = self._init_state()

    # ---------------------------------------------------------------- state
    def _init_state(self) -> Dict[str, object]:
        s, dev = self.slots, self.device
        cache = init_cache(self.model.config, s, self.bucket, self.cache_dtype, dev)
        length = torch.zeros((s,), dtype=torch.int32, device=dev)  # write frontiers
        set_frontier(cache, length)
        return dict(
            cache=cache,
            length=length,
            last=torch.zeros((s,), dtype=torch.int64, device=dev),    # next token to emit
            prev=torch.full((s,), -1, dtype=torch.int64, device=dev),  # 2-gram context
            done=torch.ones((s,), dtype=torch.bool, device=dev),       # free slots are done
            n_emit=torch.zeros((s,), dtype=torch.int64, device=dev),
            # slack columns: finished rows park their writes at max_new, and a
            # verify round's window is spec_k + 1 wide
            tokens=torch.full((s, self.cfg.max_new_tokens + self.spec_k + 1),
                              self.cfg.pad_token_id, dtype=torch.int64, device=dev),
        )

    def _first_tokens(self, logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(last0, done0) from a prefill's (n, 1, V) logits."""
        cfg = self.cfg
        last0 = torch.argmax(logits[:, -1].float(), dim=-1)
        return last0, (last0 == cfg.eos_token_id) | (last0 == cfg.stop_single)

    def _arm_rows(self, slots: torch.Tensor, length, last0, done0) -> None:
        """Reset the per-row state of ``slots`` for a new request or turn."""
        st = self._state
        st["length"].index_copy_(0, slots, length.to(torch.int32))
        st["last"].index_copy_(0, slots, last0)
        st["prev"].index_fill_(0, slots, -1)
        st["done"].index_copy_(0, slots, done0)
        st["n_emit"].index_fill_(0, slots, 0)
        st["tokens"].index_fill_(0, slots, self.cfg.pad_token_id)
        set_frontier(st["cache"], st["length"])

    # ------------------------------------------------------------ admission
    @torch.inference_mode()
    def _admit_rows(self, width: int, slot_list: List[int], padded: torch.Tensor,
                    valid: np.ndarray, rids: List[int], hold) -> None:
        """Prefill one chunk of ``len(slot_list)`` rows into a fresh mini cache
        and graft it into its slots: ``padded`` (n, width, D), ``valid`` the
        host lengths."""
        n, dev = len(slot_list), self.device
        holds = hold if isinstance(hold, list) else [hold] * n
        valid_t = torch.as_tensor(np.asarray(valid), dtype=torch.int64).to(dev)
        mini = init_cache(self.model.config, n, width, self.cache_dtype, dev)
        logits = self.model.prefill(padded.to(dev), mini, last_index=valid_t - 1)
        last0, done0 = self._first_tokens(logits)
        slots = torch.tensor(slot_list, dtype=torch.int64, device=dev)
        for big, small in zip(self._state["cache"], mini):
            for key, leaf in big.items():
                if key != "index":
                    leaf[:, :, :width].index_copy_(0, slots, small[key])
        self._arm_rows(slots, valid_t, last0, done0)
        for slot, rid, t, h in zip(slot_list, rids, valid, holds):
            self._slot_req[slot] = rid
            self._slot_prompt_len[slot] = int(t)
            self._slot_want_hold[slot] = h

    def _admit_chunk(self, width: int, items: List[Tuple[int, _Pending]]) -> None:
        n, d = len(items), items[0][1].embeds.shape[1]
        padded = torch.zeros((n, width, d), dtype=items[0][1].embeds.dtype, device=self.device)
        valid = np.zeros((n,), np.int32)
        for j, (_, req) in enumerate(items):
            t = req.embeds.shape[0]
            padded[j, :t] = req.embeds
            valid[j] = t
        self._admit_rows(width, [s for s, _ in items], padded, valid,
                         [req.request_id for _, req in items], [req.hold for _, req in items])

    def _admit_pending(self) -> None:
        """Admit queued requests into free slots, FIFO across loose requests
        and groups: a group prefills straight from its tensor in power-of-two
        chunks (a partial admission splits it); loose requests group by
        admission width and are padded here."""
        while self._queue:
            free = self._free_slots()
            if not free:
                return
            head = self._queue[0]
            if isinstance(head, _PendingBatch):
                if len(head.request_ids) > len(free):
                    head, self._queue[0] = head.split(len(free))
                else:
                    self._queue.pop(0)
                width = int(head.embeds.shape[1])
                for i, n in _chunks(len(head.request_ids), self.max_admit_chunk):
                    self._admit_rows(width, free[i:i + n], head.embeds[i:i + n],
                                     head.valid[i:i + n], head.request_ids[i:i + n], head.hold)
                continue
            run: List[_Pending] = []
            while (self._queue and len(run) < len(free)
                   and not isinstance(self._queue[0], _PendingBatch)):
                run.append(self._queue.pop(0))
            by_width: Dict[int, List[Tuple[int, _Pending]]] = {}
            for slot, req in zip(free, run):
                by_width.setdefault(self._width(req.embeds.shape[0]), []).append((slot, req))
            for width, items in by_width.items():
                for i, n in _chunks(len(items), self.max_admit_chunk):
                    self._admit_chunk(width, items[i:i + n])

    def _width(self, t: int) -> int:
        return next(w for w in self.admit_widths if w >= t)

    # ------------------------------------------------------- held conversations
    def _cont_width(self, t: int) -> int:
        """Admission-ladder width for a turn delta (>= spec_k + 1, so that a
        verify round's junk never outruns the region the delta rewrites)."""
        return self._width(max(t, self.spec_k + 1))

    def _process_continuations(self) -> None:
        """Run the queued turn deltas, per admission width in power-of-two chunks."""
        by_width: Dict[int, List[Tuple[int, _Pending]]] = {}
        for slot, req in self._cont_queue:
            by_width.setdefault(self._cont_width(req.embeds.shape[0]), []).append((slot, req))
        self._cont_queue.clear()
        for width, items in by_width.items():
            for i, n in _chunks(len(items), self.max_admit_chunk):
                self._continue_chunk(width, items[i:i + n])

    @torch.inference_mode()
    def _continue_chunk(self, width: int, items: List[Tuple[int, _Pending]]) -> None:
        """Prefill the chunk's deltas in place at their slots' frontiers.  Only
        the continuing rows run: their cache rows are gathered into an (n, ...)
        mini cache, prefilled there, and copied back, so that no co-resident
        row takes a ``width``-position junk write at its frontier."""
        n, dev = len(items), self.device
        d = items[0][1].embeds.shape[1]
        delta = torch.zeros((n, width, d), dtype=items[0][1].embeds.dtype, device=dev)
        valid = torch.zeros((n,), dtype=torch.int64)
        for j, (_, req) in enumerate(items):
            t = req.embeds.shape[0]
            delta[j, :t] = req.embeds
            valid[j] = t
        valid = valid.to(dev)
        slots = torch.tensor([s for s, _ in items], dtype=torch.int64, device=dev)
        st = self._state
        start = st["length"].index_select(0, slots)
        mini = [dict({k: v.index_select(0, slots) for k, v in c.items() if k != "index"},
                     index=start) for c in st["cache"]]
        logits = self.model.prefill(delta, mini, last_index=(valid - 1).clamp(0, width - 1))
        last0, done0 = self._first_tokens(logits)
        for big, small in zip(st["cache"], mini):
            for key, leaf in big.items():
                if key != "index":
                    leaf.index_copy_(0, slots, small[key])
        self._arm_rows(slots, start + valid, last0, done0)
        for slot, req in items:
            self._slot_req[slot] = req.request_id
            self._slot_hold[slot] = False
            self._slot_want_hold[slot] = req.hold
            self._slot_prompt_len[slot] += req.embeds.shape[0]
            self._frontier_host[slot] += req.embeds.shape[0]

    # --------------------------------------------------------------- decode
    @torch.inference_mode()
    def _segment(self):
        """Up to ``segment`` greedy decode steps over every slot, stopping
        when every row is done; emit and stop rules as
        ``generation._decode_loop``, with per-row output offsets.  Returns
        (steps, live row-steps, 0, 0)."""
        st, cfg, model = self._state, self.cfg, self.model
        max_new = cfg.max_new_tokens
        cache, length, last, prev = st["cache"], st["length"], st["last"], st["prev"]
        done, n_emit, tokens = st["done"], st["n_emit"], st["tokens"]
        rows = torch.arange(self.slots, device=self.device)
        live = torch.zeros((), dtype=torch.int64, device=self.device)
        steps = 0
        while steps < self.segment and not bool(done.all()):
            active = ~done
            # emit `last` at each active row's own offset; done and free rows
            # park a pad in the slack column
            offset = torch.where(done, max_new, n_emit.clamp(max=max_new - 1))
            tokens[rows, offset] = torch.where(active, last, cfg.pad_token_id)
            set_frontier(cache, length)
            logits = model(model.embed(last[:, None]), cache)
            nxt = torch.argmax(logits[:, -1].float(), dim=-1)
            step = active.long()
            n_emit = n_emit + step
            done = done | _stopped(last, nxt, cfg) | (n_emit >= max_new)
            # frontiers advance only for active rows (done and free rows
            # rewrote their frontier slot: junk the mask excludes)
            length = length + step.int()
            prev = torch.where(active, last, prev)
            last = torch.where(active, nxt, last)
            live = live + step.sum()
            steps += 1
        set_frontier(cache, length)
        st.update(length=length, last=last, prev=prev, done=done, n_emit=n_emit)
        zero = torch.zeros_like(live)
        return steps, live, zero, zero

    @torch.inference_mode()
    def _segment_spec(self):
        """Up to ``segment`` verify rounds: each feeds every row's ``last`` and
        ``spec_k`` drafts (the most recent 2-gram, else 1-gram, match in the
        lookup corpus followed by the row's own output) as one (slots, K+1)
        chunk, accepts the leading drafts that equal the model's greedy
        tokens and emits them with ``greedy_generate``'s stop rules.  Done
        and free rows stand still.  Returns (rounds, live row-rounds,
        accepted, drafted)."""
        st, cfg, model = self._state, self.cfg, self.model
        max_new, k, dev = cfg.max_new_tokens, self.spec_k, self.device
        vocab = model.config.vocab_size
        cache, length, last, prev = st["cache"], st["length"], st["last"], st["prev"]
        done, n_emit, tokens = st["done"], st["n_emit"], st["tokens"]
        lookup, lp = None, 0
        if self._lookup_ids is not None:
            lookup = torch.as_tensor(self._lookup_ids, device=dev)[None].expand(self.slots, -1)
            lp = lookup.shape[1]
        cols = torch.arange(k + 1, device=dev)
        live, acc, drf = (torch.zeros((), dtype=torch.int64, device=dev) for _ in range(3))
        rounds = 0
        while rounds < self.segment and not bool(done.all()):
            active = ~done
            corpus = tokens if lookup is None else torch.cat([lookup, tokens], dim=1)
            draft = _lookup_drafts(corpus, prev, last, n_emit + lp, k).clamp(0, vocab - 1)
            feed = torch.cat([last[:, None], draft], dim=1)                   # (B, K+1)
            set_frontier(cache, length)
            g = torch.argmax(model(model.embed(feed), cache).float(), dim=-1)  # (B, K+1)
            chain = torch.cat([last[:, None], g], dim=1)                      # (B, K+2)
            a = torch.cumprod((feed[:, 1:] == g[:, :-1]).long(), dim=1).sum(dim=1)

            # emit chain[0..a] with the greedy loop's stop rules; done and
            # free rows park an all-pad window in the slack column
            window, done_j, n_new = _emit_window(chain, a, done, cfg)
            offset = torch.where(done, max_new, n_emit.clamp(max=max_new - 1))
            tokens.scatter_(1, offset[:, None] + cols[None, :], window)
            n_emit = n_emit + n_new
            # the frontier advances by the tokens emitted, not a + 1: a stop
            # inside the accepted window leaves it at the emitted end, so a
            # held slot's resident K/V agrees with its raw tokens
            length = torch.where(active, length + n_new.int(), length)
            done = done_j | (n_emit >= max_new)
            ai = active.long()
            last = torch.where(active, chain.gather(1, (a + 1)[:, None])[:, 0], last)
            prev = torch.where(active, chain.gather(1, a[:, None])[:, 0], prev)
            live = live + ai.sum()
            acc = acc + (a * ai).sum()
            drf = drf + k * ai.sum()
            rounds += 1
        set_frontier(cache, length)
        st.update(length=length, last=last, prev=prev, done=done, n_emit=n_emit)
        return rounds, live, acc, drf

    # ----------------------------------------------------------------- API
    def set_lookup(self, ids) -> None:
        """Install the shared prompt-lookup corpus (spec_k > 0); before the
        first decode segment, as the JAX engine bakes it into its program."""
        if self._segment_prog is not None:
            raise RuntimeError("set_lookup after the first decode segment")
        self._lookup_ids = np.asarray(torch.as_tensor(ids).cpu(), np.int64).reshape(-1)

    def _check_fits(self, t: int) -> None:
        # slack 2K+1: a verify round can overshoot max_new by K emitted tokens,
        # and a finished row that stays resident keeps junk-writing K+1
        # positions at its frontier while co-residents decode; the junk must
        # stay inside the bucket, or the clamped write would overwrite a held
        # row's own history
        slack = 2 * self.spec_k + 1
        if t + self.cfg.max_new_tokens + slack > self.bucket:
            raise ValueError(f"prompt of {t} tokens + max_new {self.cfg.max_new_tokens} "
                             f"(+{slack} verify slack) does not fit the {self.bucket}-token "
                             "bucket")

    def _new_id(self, request_id: Optional[int]) -> int:
        rid = self._next_id if request_id is None else request_id
        self._next_id = max(self._next_id, rid) + 1
        return rid

    def submit(self, embeds, request_id: Optional[int] = None, hold: bool = False) -> int:
        """Enqueue a request: ``embeds`` (T, D) prompt embeddings.  ``hold``
        keeps the slot (prompt and generated K/V) resident after the request
        finishes, for ``continue_request``."""
        embeds = torch.as_tensor(embeds)
        if embeds.dim() != 2:
            raise ValueError(f"submit takes one (T, D) prompt, got {tuple(embeds.shape)}")
        t = embeds.shape[0]
        self._check_fits(t)
        if t > self.admit_widths[-1]:
            raise ValueError(f"prompt of {t} tokens exceeds the largest admission width "
                             f"{self.admit_widths[-1]}")
        rid = self._new_id(request_id)
        self._queue.append(_Pending(rid, embeds, hold))
        self.stats["submitted"] += 1
        return rid

    def reserve_ids(self, n: int) -> List[int]:
        """Claim ``n`` request ids for a group a lazy front end submits later
        (``submit_group(..., request_ids=...)``)."""
        rids = list(range(self._next_id, self._next_id + n))
        self._next_id += n
        return rids

    def submit_group(self, embeds, valid, hold: bool = False,
                     request_ids: Optional[List[int]] = None) -> List[int]:
        """Enqueue a same-width group as one tensor: ``embeds`` (n, width, D)
        with ``width`` on the admission ladder, ``valid`` the true prompt
        lengths (an int or (n,)).  A tensor on the engine's device stays there
        until its admission prefill, unless the queue already holds
        ``max_queued_device_bytes`` of device prompts: then the group moves to
        the host and is uploaded again at admission, which bounds the device
        memory held by prompts that cannot admit yet.  A group given on
        another device (a numpy array, say) is a host group.  FIFO with
        ``submit``: one queue."""
        embeds = torch.as_tensor(embeds)
        host = embeds.device != self.device
        n, width = int(embeds.shape[0]), int(embeds.shape[1])
        if width not in self.admit_widths:
            raise ValueError(f"group width {width} is not on the admission ladder "
                             f"{self.admit_widths}: pad to a ladder width")
        valid = np.broadcast_to(np.asarray(valid, np.int32), (n,)).copy()
        worst = int(valid.max()) if n else 0
        self._check_fits(worst)
        if n and (worst > width or int(valid.min()) < 1):
            raise ValueError(f"valid lengths must lie in [1, width={width}]; got "
                             f"[{int(valid.min())}, {worst}]: a wrong valid makes the prefill "
                             "read a pad position")
        if not host and (self._queued_device_bytes() + _nbytes(embeds)
                         > self.max_queued_device_bytes):
            embeds, host = embeds.cpu(), True
        if request_ids is None:
            rids = self.reserve_ids(n)
        else:
            if len(request_ids) != n:
                raise ValueError(f"{len(request_ids)} reserved ids for {n} embed rows")
            rids = list(request_ids)
        # the queued group keeps its own list: a caller extending the returned
        # list in place must not grow the group
        self._queue.append(_PendingBatch(list(rids), embeds, valid, hold, host))
        self.stats["submitted"] += n
        return rids

    def continue_request(self, handle: int, delta_embeds, request_id: Optional[int] = None,
                         hold: bool = False) -> int:
        """Extend the held conversation ``handle`` (the finished request's id)
        with the next turn's (T, D) embeddings, prefilled in place at the
        slot's frontier.  The caller's delta accounts for the previous turn's
        raw tokens (``Finished.raw_tokens``), which are already resident."""
        if handle not in self._held:
            raise KeyError(f"no held conversation {handle} (held: {sorted(self._held)})")
        delta_embeds = torch.as_tensor(delta_embeds)
        if delta_embeds.dim() != 2:
            raise ValueError(f"continue_request takes a (T, D) delta, got "
                             f"{tuple(delta_embeds.shape)}")
        t = delta_embeds.shape[0]
        if t > self.admit_widths[-1]:
            raise ValueError(f"delta of {t} tokens exceeds the largest admission width "
                             f"{self.admit_widths[-1]}")
        slot = self._held[handle]
        frontier = int(self._frontier_host[slot])
        width = self._cont_width(t)
        # two bounds, the lease kept on rejection: the decode budget (slack as
        # in submit) and the delta's own padded prefill, which must not clamp
        # into the row's history
        if (frontier + t + self.cfg.max_new_tokens + 2 * self.spec_k + 1 > self.bucket
                or frontier + width > self.bucket):
            raise ValueError(f"conversation at frontier {frontier} + delta {t} (padded "
                             f"{width}) + max_new {self.cfg.max_new_tokens} overflows the "
                             f"{self.bucket} bucket")
        del self._held[handle]
        rid = self._new_id(request_id)
        self._cont_queue.append((slot, _Pending(rid, delta_embeds, hold)))
        self.stats["submitted"] += 1
        return rid

    def release(self, handle: int) -> None:
        """Free a held conversation's slot."""
        slot = self._held.pop(handle)
        self._slot_hold[slot] = False

    @property
    def queued_rows(self) -> int:
        """Rows waiting in the admission queue (not yet in slots)."""
        return sum(len(e.request_ids) if isinstance(e, _PendingBatch) else 1
                   for e in self._queue)

    @property
    def free_slot_count(self) -> int:
        return len(self._free_slots())

    def _queued_device_bytes(self) -> int:
        return sum(_nbytes(e.embeds) for e in self._queue
                   if isinstance(e, _PendingBatch) and not e.host)

    def _free_slots(self) -> List[int]:
        return [s for s in range(self.slots)
                if self._slot_req[s] is None and not self._slot_hold[s]]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self) -> List[Finished]:
        """One scheduler tick: run queued turn deltas, admit pending requests
        into free slots, run one decode segment and collect the finished rows."""
        t0 = time.monotonic()
        self._process_continuations()
        self._admit_pending()
        if self.profile_sync:
            self._sync()
        t1 = time.monotonic()
        self.stats["admit_wall_s"] = self.stats.get("admit_wall_s", 0.0) + (t1 - t0)
        occupied = [s for s in range(self.slots) if self._slot_req[s] is not None]
        if not occupied:
            return []
        if self._segment_prog is None:
            self._segment_prog = self._segment_spec if self.spec_k else self._segment
        nsteps, live, acc, drf = self._segment_prog()
        # one device-to-host copy of every per-tick value the scheduler reads
        st, s = self._state, self.slots
        host = torch.cat([torch.stack([live, acc, drf]), st["length"].long(),
                          st["done"].long(), st["n_emit"], st["tokens"].flatten()]).cpu().numpy()
        live, acc, drf = (int(x) for x in host[:3])
        length, done, n_emit = host[3:3 + s], host[3 + s:3 + 2 * s], host[3 + 2 * s:3 + 3 * s]
        tokens = host[3 + 3 * s:].reshape(s, -1)
        self.stats["ticks"] += 1
        self.stats["decode_steps"] += int(nsteps)
        self.stats["live_row_steps"] += live
        self.stats["spec_accepted"] += acc
        self.stats["spec_drafted"] += drf
        self._frontier_host = length.astype(np.int64)
        self.stats["decode_wall_s"] = (self.stats.get("decode_wall_s", 0.0)
                                       + (time.monotonic() - t1))

        finished: List[Finished] = []
        for slot in occupied:
            if not done[slot]:
                continue
            rid, hold = self._slot_req[slot], self._slot_want_hold[slot]
            finished.append(Finished(
                request_id=rid, tokens=self._trim(tokens[slot]),
                n_prompt=self._slot_prompt_len[slot],
                raw_tokens=tokens[slot][:n_emit[slot]].astype(np.int32), held=hold))
            self._slot_req[slot] = None
            if hold:
                self._slot_hold[slot] = True
                self._held[rid] = slot
        self.stats["completed"] += len(finished)
        return finished

    def drain(self, max_ticks: int = 10_000) -> List[Finished]:
        """Run ticks until the queue, the turn queue and every active slot are
        empty (held conversations idle without blocking the drain)."""
        out: List[Finished] = []
        for _ in range(max_ticks):
            if (not self._queue and not self._cont_queue
                    and all(r is None for r in self._slot_req)):
                return out
            out.extend(self.step())
        raise RuntimeError("drain did not converge (stuck request?)")

    @property
    def pending(self) -> int:
        return (self.queued_rows + len(self._cont_queue)
                + sum(r is not None for r in self._slot_req))

    def _trim(self, row: np.ndarray) -> np.ndarray:
        """A raw output row trimmed at stop/eos/pad (``trim_stop_ids``)."""
        return np.asarray(trim_stop_ids(row[: self.cfg.max_new_tokens], self.cfg), np.int32)
