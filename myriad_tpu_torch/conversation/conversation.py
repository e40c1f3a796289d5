"""Interactive chat over the port's Myriad (counterpart of
``myriad_tpu/conversation/conversation.py``).

``Conversation`` is the ###-separated Human/Assistant prompt state machine;
``Chat`` wires it to a ``Myriad``: upload an image, ask, answer by greedy
decode (or speculative decode, ``spec_k``).  Chat runs on its model's device.

With ``incremental=True`` the conversation's KV cache stays resident on the
device between turns: each ``answer`` prefills only the prompt units that are
new since the cached prefix (``generation.continue_generate``), where the
reference re-runs its whole history every turn.  Two things differ from the
JAX package's ``Chat``:

- ``upload_img`` takes an HWC uint8 image and normalises it itself, as
  ``LocImageTrainProcessor(identity=True)`` does, with the port's CLIP
  constants (the processor module imports PIL, which the card lacks);
- the delta is prefilled at its exact width.  The JAX package pads it to a
  multiple of 64 (``DELTA_PAD``) only to bound the number of XLA programs it
  compiles; eager PyTorch compiles none, and the transcripts are the same
  (``tests/test_torch_chat.py``).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from myriad_tpu_torch.generation import (GenerationConfig, _round_up, continue_generate,
                                         greedy_generate, speculative_generate)
from myriad_tpu_torch.models.llama import init_cache, serving_cache_dtype
from myriad_tpu_torch.ops.preprocess import u8_normalize


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str] = ("Human", "Assistant")
    messages: List[List[str]] = dataclasses.field(default_factory=list)
    sep: str = "###"
    offset: int = 0

    def append_message(self, role: str, message: Optional[str]) -> None:
        self.messages.append([role, message])

    def get_prompt(self) -> str:
        ret = self.system + self.sep
        for role, message in self.messages:
            if message:
                ret += role + ": " + message + self.sep
            else:
                ret += role + ":"
        return ret

    def copy(self) -> "Conversation":
        return Conversation(system=self.system, roles=self.roles,
                            messages=[list(m) for m in self.messages], sep=self.sep,
                            offset=self.offset)


CONV_VISION = Conversation(
    system="Give the following image: <Img>ImageContent</Img>. "
    "You will be able to see the image once I provide it to you. "
    "Please answer my questions.",
    roles=("Human", "Assistant"),
)


class Chat:
    """Chat driver over a ``Myriad`` (``myriad_tpu_torch.models.myriad``).

    ``spec_k``: speculative decoding depth for incremental turns; None follows
    the model's ``spec_k`` (``llm_spec_k``), 0 disables.  It engages only on
    greedy turns.  The resident cache is re-prefilled from scratch when the
    conversation is new, when it outgrows its 256-position bucket, when the
    prompt diverges inside the cached prefix (an edited history, a replaced
    image), or when the prompt did not grow past the cached frontier.
    """

    BUCKET = 256  # the resident cache grows in steps of this many positions

    def __init__(self, model, incremental: bool = True, spec_k: Optional[int] = None):
        self.model = model
        self.incremental = incremental
        self.spec_k = spec_k
        # incremental state: the resident cache, its frontier, and the token
        # units it covers (text ids; image i's columns as ("img", i, serial))
        self._cache = None
        self._frontier = 0
        self._units: List = []
        self._bucket = 0
        # a unit names the image embedding OBJECT, so replacing an img_list
        # entry never reuses the old image's K/V; a finalizer retires the
        # id() key when the object dies, so a reused id() cannot alias it
        self._embed_serials: Dict[int, int] = {}
        self._next_serial = 0
        # prefill width of each incremental turn (observes the prefix reuse)
        self._delta_log: List[int] = []

    def _embed_serial(self, emb: torch.Tensor) -> int:
        key = id(emb)
        if key not in self._embed_serials:
            self._embed_serials[key] = self._next_serial
            self._next_serial += 1
            weakref.finalize(emb, self._embed_serials.pop, key, None)
        return self._embed_serials[key]

    @torch.inference_mode()
    def upload_img(self, image, conv: Conversation, img_list: List) -> str:
        """Encode an HWC uint8 image into LLM-space tokens, with the expert's
        maps of the generic 'object' class (``prepare_sample``'s ``maps``: the
        zero-shot ones of the ImageBind expert; zeros without an expert)."""
        model = self.model
        u8 = torch.as_tensor(np.asarray(image, np.uint8), device=model.device)
        arr = u8_normalize(u8, out_dtype=torch.float32)[None]
        ve = model.vision_expert
        if ve is not None and "object" not in ve.class_index:
            ve.class_names = list(ve.class_names) + ["object"]
            ve.class_index["object"] = len(ve.class_names) - 1
            ve._text_feats = None
        samples = {"image": arr, "scene": ["object"],
                   "question": ["<Img><ImageHere></Img>placeholder"], "img_path": ["<chat>"]}
        img, _, _, maps, _ = model.prepare_sample(samples, stage=1, training=False)
        img_list.append(model.module.encode_img(img, maps, 1))
        conv.append_message(conv.roles[0], "<Img><ImageHere></Img>")
        return "Received."

    def ask(self, text: str, conv: Conversation) -> None:
        if (conv.messages and conv.messages[-1][0] == conv.roles[0]
                and conv.messages[-1][1] and conv.messages[-1][1].endswith("</Img>")):
            conv.messages[-1][1] = conv.messages[-1][1] + " " + text
        else:
            conv.append_message(conv.roles[0], text)

    def _context_units(self, conv: Conversation, img_list: List) -> Tuple[List, List[List[int]]]:
        """The flattened unit sequence of the prompt (text ids, and one
        ("img", i, serial) unit per column of image i) and the per-segment
        ids.  Two prompts share cached K/V exactly as far as their units
        agree."""
        segments = conv.get_prompt().split("<ImageHere>")
        if len(segments) != len(img_list) + 1:
            raise ValueError("prompt/image count mismatch")
        tok = self.model.llama_tokenizer
        units: List = []
        seg_ids: List[List[int]] = []
        for i, seg in enumerate(segments):
            ids = tok(seg, add_special_tokens=(i == 0))["input_ids"]
            ids = [int(t) for t in (ids[0] if ids and isinstance(ids[0], list) else ids)]
            seg_ids.append(ids)
            units.extend(ids)
            if i < len(img_list):
                units.extend([("img", i, self._embed_serial(img_list[i]))]
                             * img_list[i].shape[1])
        return units, seg_ids

    def _embed_ids(self, ids: List[int]) -> torch.Tensor:
        ids_t = torch.tensor([ids], dtype=torch.int64, device=self.model.device)
        return self.model.module.embed_tokens(ids_t)

    def get_context_emb(self, conv: Conversation, img_list: List) -> torch.Tensor:
        """Text segments and image embeddings interleaved into the whole
        prompt's embedding: the reference-shaped full re-prefill input."""
        _, seg_ids = self._context_units(conv, img_list)
        embeds = []
        for i, ids in enumerate(seg_ids):
            seg_emb = self._embed_ids(ids)
            embeds.append(seg_emb)
            if i < len(img_list):
                embeds.append(img_list[i].to(seg_emb.dtype))
        return torch.cat(embeds, dim=1)

    def _embed_units(self, units: List, img_list: List) -> torch.Tensor:
        """(1, len(units), D) embedding of a unit slice: text runs embed, image
        runs reuse the encoder output (a partial run is always the tail of an
        image's columns: identical units diverge at its first column)."""
        runs: List = []  # ["txt", ids] | ["img", i, n_cols]
        for u in units:
            if isinstance(u, tuple):
                if runs and runs[-1][0] == "img" and runs[-1][1] == u[1]:
                    runs[-1][2] += 1
                else:
                    runs.append(["img", u[1], 1])
            elif runs and runs[-1][0] == "txt":
                runs[-1][1].append(u)
            else:
                runs.append(["txt", [u]])
        dtype = self.model.policy.compute_dtype
        parts = [self._embed_ids(r[1]) if r[0] == "txt"
                 else img_list[r[1]][:, img_list[r[1]].shape[1] - r[2]:] for r in runs]
        return torch.cat([p.to(dtype) for p in parts], dim=1)

    def _cache_dtype(self):
        return serving_cache_dtype(self.model.arch.llama, self.model.policy.compute_dtype)

    def _spec_k(self, cfg: GenerationConfig) -> int:
        """This turn's speculation depth: the Chat's override or the model's
        knob, on greedy turns only.  As in the JAX package, a turn that
        samples with ``top_p <= 0.01`` counts as greedy here, whatever its
        temperature."""
        k = self.spec_k
        if k is None:
            k = int(getattr(self.model, "spec_k", 0) or 0)
        greedy = (not cfg.do_sample) or cfg.top_p <= 0.01
        return k if k >= 1 and greedy else 0

    @torch.inference_mode()
    def answer(self, conv: Conversation, img_list: List, max_new_tokens: int = 300,
               **kwargs) -> Tuple[str, np.ndarray]:
        conv.append_message(conv.roles[1], None)
        cfg = GenerationConfig(max_new_tokens=max_new_tokens,
                               do_sample=kwargs.get("do_sample", False),
                               top_p=kwargs.get("top_p", 0.9),
                               temperature=kwargs.get("temperature", 1.0))
        if cfg.do_sample and not (self.incremental and self._spec_k(cfg)):
            # only speculation turns a sampled turn greedy (_spec_k)
            raise NotImplementedError("top-p sampling is not ported; greedy only")
        if self.incremental:
            units, _ = self._context_units(conv, img_list)
            tokens = self._incremental_generate(cfg, units, img_list)
        else:
            tokens = greedy_generate(self.model.module.llama,
                                     self.get_context_emb(conv, img_list), config=cfg,
                                     cache_dtype=self._cache_dtype())
        tokens = tokens.cpu().numpy()
        text = self.model.llama_tokenizer.batch_decode(tokens)[0]
        text = text.split("###")[0].split("Assistant:")[-1].strip()
        conv.messages[-1][1] = text
        return text, tokens

    def _incremental_generate(self, cfg: GenerationConfig, units: List,
                              img_list: List) -> torch.Tensor:
        """Prefill only the units past the cached prefix, decode from the
        resident cache, and keep the post-prefill cache for the next turn."""
        llama = self.model.module.llama
        spec_k = self._spec_k(cfg)
        total = len(units)
        common = 0  # longest cached prefix this prompt still agrees with
        for a, b in zip(self._units[:self._frontier], units):
            if a != b:
                break
            common += 1
        # a verify round writes up to spec_k + 1 positions past the frontier
        bucket = _round_up(total + cfg.max_new_tokens + (spec_k + 1 if spec_k else 0),
                           self.BUCKET)
        if (self._cache is None or bucket != self._bucket or common != self._frontier
                or total <= self._frontier):
            # a partial rollback would be unsound when the new prompt is
            # shorter than the old frontier: the stale slots between them sit
            # at positions the causal mask admits
            self._cache = init_cache(llama.config, 1, bucket, self._cache_dtype(),
                                     self.model.device)
            self._bucket = bucket
            common = 0
        self._delta_log.append(total - common)
        delta = self._embed_units(units[common:], img_list)
        if spec_k:
            # the lookup corpus is the conversation's text, padded with an id
            # no token takes to a 256 multiple, as the JAX package pads it, so
            # the drafts (and the acceptance counts) are the same
            text_ids = [u for u in units if not isinstance(u, tuple)]
            width = _round_up(max(len(text_ids), 1), 256)
            lookup = torch.tensor([text_ids + [-3] * (width - len(text_ids))],
                                  dtype=torch.int64, device=self.model.device)
            tokens, self._cache = speculative_generate(
                llama, delta, config=dataclasses.replace(cfg, do_sample=False),
                spec_k=spec_k, lookup_ids=lookup,
                cache=self._cache, return_cache=True)
        else:
            tokens, self._cache = continue_generate(llama, delta, self._cache, config=cfg)
        self._frontier = total
        self._units = list(units)
        return tokens
