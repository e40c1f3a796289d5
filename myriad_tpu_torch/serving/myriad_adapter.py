"""Myriad front end for the continuous-batching engine (counterpart of
``myriad_tpu/serving/myriad_adapter.py``).

Turns (image, question) anomaly-QA samples into LLM prompt embeddings
(the expert's maps, one-shot when the model's ``k_shot > 0``, ``encode_img``
and the prompt wrap: the chain ``Myriad.generate`` runs) and streams them through a ``ServingEngine`` over
the model's Vicuna decoder.  Where ``Myriad.generate`` serves one fixed
batch a call, this front end serves an endpoint: requests arrive at any
time, admit into free KV slots and finish independently.  It runs on the
model's device.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from myriad_tpu_torch.generation import GenerationConfig
from myriad_tpu_torch.models.llama import serving_cache_dtype
from myriad_tpu_torch.serving.engine import ServingEngine

QUESTION_KEYS = {0: "question", 1: "question2", 2: "question3"}


def _scene0(scene) -> str:
    """First scene of a sample's scene field, accepting a plain string
    (list('bottle')[0] would be 'b')."""
    if isinstance(scene, str):
        return scene
    seq = list(scene)
    return seq[0] if seq else ""


class MyriadServing:
    """Continuous serving of anomaly-QA requests on a Myriad model.

    Arguments mirror ``ServingEngine``'s; the generation defaults (stop ids,
    KV dtype, bos) come from the wrapped model, so transcripts match
    ``Myriad.generate``'s greedy path."""

    def __init__(self, myriad, *, slots: int = 8, bucket: Optional[int] = None,
                 segment: int = 32, max_new_tokens: int = 90, admit_widths=(128, 256, 512),
                 stage: int = 1, spec_k: int = 0, max_admit_chunk: int = 16):
        self.myriad = myriad
        self.stage = stage
        self.cfg = GenerationConfig(max_new_tokens=max_new_tokens)
        cache_dtype = serving_cache_dtype(myriad.arch.llama, myriad.policy.compute_dtype)
        if bucket is None:
            # rounded to 32 positions; slack rationale: ServingEngine.submit
            bucket = -(-(max(admit_widths) + max_new_tokens + 2 * spec_k + 1) // 32) * 32
        self.engine = ServingEngine(
            myriad.module.llama, slots=slots, bucket=bucket, config=self.cfg,
            cache_dtype=cache_dtype, segment=segment, admit_widths=admit_widths,
            spec_k=spec_k, max_admit_chunk=max_admit_chunk)
        self._meta: Dict[int, Dict] = {}
        # each group's VE anomaly scores (the max of its maps, the jsonl
        # `anomaly_score`) as [scores, renders outstanding]: kept on the device
        # until the group's first render, dropped after its last
        self._group_scores: Dict[int, list] = {}
        self._next_gid = 0
        # lazy submission: stacked sample groups waiting to be embedded, with
        # their reserved request ids (submit_batch(lazy=True))
        self._host_queue: List[tuple] = []

    def _embed(self, image, maps, before, after):
        """(embeddings padded to the admission-ladder width (n, width, D), the
        true length).  The width is known before the forward, from the prompt
        pieces and ``image_tokens``."""
        m = self.myriad
        t = (before.numel() + m.module.image_tokens(self.stage) + after.numel()
             + int(m.bos_at_generate))
        ladder = self.engine.admit_widths
        width = next((w for w in ladder if w >= t), None)
        if width is None:
            raise ValueError(f"prompt of {t} tokens exceeds the largest admission width "
                             f"{ladder[-1]}")
        emb = m.module.prefill_embeds(image, maps, before, after, self.stage,
                                      add_bos=m.bos_at_generate)
        if emb.shape[1] != t:
            raise RuntimeError(f"prefill_embeds gave {emb.shape[1]} positions, not {t}")
        return torch.nn.functional.pad(emb, (0, 0, 0, width - t)), t

    def submit(self, samples: Dict) -> int:
        """Enqueue one sample (a dict with 'image' (1, H, W, C), 'question*'
        and 'scene'); returns the request id."""
        return self._submit_group(samples)[0]

    def submit_batch(self, samples_list: List[Dict], max_group: int = 16,
                     lazy: bool = False) -> List[int]:
        """Enqueue many single-image samples; runs of one image shape and one
        question share one embed forward, at most ``max_group`` rows.  Returns
        the request ids in input order.

        ``lazy=True`` defers the embed forwards: groups wait on the host and
        are embedded just ahead of admission (``_pump``), so a deep burst holds
        images in host memory rather than prompt embeddings on the device.
        The ids are reserved at once."""
        ids: List[int] = []
        group: List[Dict] = []
        q_key = QUESTION_KEYS[self.stage]

        def gkey(s):
            img = np.asarray(s["image"])
            q = s.get(q_key) or s.get("question")
            q = q[0] if isinstance(q, (list, tuple)) else q
            return (img.shape[1:], img.dtype.str, q)

        def flush():
            if not group:
                return
            stacked = {"image": np.concatenate([np.asarray(s["image"]) for s in group]),
                       "scene": [_scene0(s.get("scene", "")) for s in group]}
            for k in ("question", "question2", "question3", "img_path"):
                vals = [s[k] for s in group if k in s]
                if vals:
                    stacked[k] = [v[0] if isinstance(v, (list, tuple)) else v for v in vals]
            if lazy:
                rids = self.engine.reserve_ids(len(group))
                self._host_queue.append((stacked, rids))
                ids.extend(rids)
            else:
                ids.extend(self._submit_group(stacked))
            group.clear()

        for s in samples_list:
            if group and (gkey(group[-1]) != gkey(s) or len(group) >= max_group):
                flush()
            group.append(s)
        flush()
        if lazy:
            self._pump()
        return ids

    def _pump(self) -> None:
        """Embed host-queued groups only while the engine's queue does not
        already cover the free slots: about one group past what can admit."""
        eng = self.engine
        while self._host_queue and eng.queued_rows <= eng.free_slot_count:
            stacked, rids = self._host_queue.pop(0)
            self._submit_group(stacked, request_ids=rids)

    @torch.inference_mode()
    def _submit_group(self, samples: Dict, hold: bool = False,
                      request_ids: Optional[List[int]] = None) -> List[int]:
        """Embed a same-question batch in one forward and enqueue its rows."""
        m = self.myriad
        # the maps generate feeds: one-shot when k_shot > 0 and the bank is
        # built, the muxed expert's, or zeros
        image, question, maps = m.serving_maps(samples, self.stage)
        before, after = m.split_prompt(question)
        eng = self.engine
        if eng.spec_k and eng._lookup_ids is None and eng._segment_prog is None:
            # the shared lookup corpus from the first request's question: AQA
            # serving is templated, so the post-image prompt and the task's
            # answer sentences draft for every request
            eng.set_lookup(m._spec_lookup_ids(after))
        embeds, t = self._embed(image, maps, before, after)
        n = embeds.shape[0]
        scenes = list(samples.get("scene", [""] * n))
        if len(scenes) != n:
            raise ValueError(f"{n} image rows but {len(scenes)} scenes: every row needs "
                             "its scene")
        rids = eng.submit_group(embeds, t, hold=hold, request_ids=request_ids)
        gid, self._next_gid = self._next_gid, self._next_gid + 1
        self._group_scores[gid] = [torch.amax(maps, dim=(1, 2, 3)), len(rids)]
        for row, (rid, scene) in enumerate(zip(rids, scenes)):
            self._meta[rid] = {"scene": scene, "question": question, "_score_ref": (gid, row)}
        return rids

    def submit_held(self, samples: Dict) -> int:
        """``submit``, with the slot kept resident after completion for
        ``continue_request`` turns."""
        if np.asarray(samples["image"]).shape[0] != 1:
            raise ValueError("submit_held takes a single-image sample")
        return self._submit_group(samples, hold=True)[0]

    @torch.inference_mode()
    def continue_request(self, handle: int, text: str, *, hold: bool = True,
                         request_id: Optional[int] = None) -> int:
        """Extend a held conversation with the next turn's text.  The delta is
        the text's token embeddings alone: the earlier prompt and answer are
        resident."""
        ids = self.myriad.llama_tokenizer(text, add_special_tokens=False)["input_ids"]
        if ids and isinstance(ids[0], list):
            ids = ids[0]
        model = self.engine.model
        emb = model.embed(torch.tensor(ids, dtype=torch.int64, device=self.engine.device))
        rid = self.engine.continue_request(handle, emb, hold=hold, request_id=request_id)
        # the turn inherits the scene; the consumed handle's meta retires
        prev_meta = self._meta.pop(handle, {})
        self._meta[rid] = {"question": text,
                           **{k: v for k, v in prev_meta.items() if k == "scene"}}
        return rid

    def release(self, handle: int) -> None:
        self.engine.release(handle)
        self._meta.pop(handle, None)

    def step(self) -> List[Dict]:
        self._pump()
        return [self._render(f) for f in self.engine.step()]

    def drain(self, max_ticks: int = 10_000) -> List[Dict]:
        out: List[Dict] = []
        for _ in range(max_ticks):
            if not self.pending:
                return out
            out.extend(self.step())
        raise RuntimeError(f"drain did not converge in {max_ticks} ticks")

    def _render(self, finished) -> Dict:
        text = self.myriad.llama_tokenizer.decode(finished.tokens.tolist())
        if finished.held:  # keep the meta: continue_request inherits the scene
            meta = dict(self._meta.get(finished.request_id, {}))
        else:
            meta = self._meta.pop(finished.request_id, {})
        ref = meta.pop("_score_ref", None)
        if ref is not None:
            gid, row = ref
            entry = self._group_scores[gid]
            if torch.is_tensor(entry[0]):  # first render: one (n,) host copy
                entry[0] = entry[0].float().cpu().numpy()
            meta["anomaly_score"] = float(entry[0][row])
            if not finished.held:
                entry[1] -= 1
                if entry[1] <= 0:
                    del self._group_scores[gid]
        return dict(request_id=finished.request_id, text=text, token_ids=finished.tokens,
                    held=finished.held, raw_tokens=finished.raw_tokens, **meta)

    @property
    def pending(self) -> int:
        return self.engine.pending + sum(len(rids) for _, rids in self._host_queue)

    @property
    def stats(self):
        return self.engine.stats
