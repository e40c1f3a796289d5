"""Myriad, the composed IAD vision-language model, for serving and training
(counterpart of ``myriad_tpu/models/myriad.py``).

    EVA-ViT-g -> LoraAdaptorV2 -> ln_vision -> Q-Former (32 queries + 49
    VEInstructor tokens) -> llama_proj [+ 18 VETokenizer tokens] -> Vicuna-7B

with the ImageBind vision expert producing the anomaly maps that feed the
two map encoders.  ``MyriadModule`` holds the weights and the compute;
``Myriad`` is the host class: prompt tokenisation, the vision expert's
text-feature cache, ``generate`` (greedy, or speculative when
``spec_k > 0``) and the training step's pieces (``prepare_train_arrays``,
``train_loss``, ``forward``).  The trainable parameters are chosen by name
as the JAX package's ``_trainable_predicate`` chooses its paths; under a
policy with fp32 parameters and bf16 compute (``Policy.bf16``, the JAX
package's default) the frozen float parameters are stored in bf16 and the
trainables and LayerNorm scales in fp32, as its ``_cast_frozen`` leaves
them.  A model built with ``training=True`` gives its trainables
``requires_grad``.  One-shot maps and top-p sampling are not ported.
``Myriad`` builds on the card unless the caller passes another device.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from myriad_tpu_torch import checkpoint as ckpt_lib
from myriad_tpu_torch.datasets.anomaly_detection import ABNORMAL_DESCRIBE, NORMAL_DESCRIBE
from myriad_tpu_torch.generation import (GenerationConfig, greedy_generate,
                                         speculative_generate)
from myriad_tpu_torch.models.clip_tokenizer import HashTokenizer
from myriad_tpu_torch.models.eva_vit import EvaViT
from myriad_tpu_torch.models.imagebind import ImageBindConfig
from myriad_tpu_torch.models.layers import (Dense, LayerNorm, LayerNormFp32, Policy,
                                            init_random_, new_param)
from myriad_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM, lm_cross_entropy,
                                           serving_cache_dtype)
from myriad_tpu_torch.models.networks import LoraAdaptorV2, VEInstructorV2, VETokenizer
from myriad_tpu_torch.models.qformer import QFormer
from myriad_tpu_torch.models.vision_expert import AnomalyExpertModule, VisionExpert
from myriad_tpu_torch.ops.preprocess import u8_normalize
from myriad_tpu_torch.tokenization import ByteTokenizer


@dataclasses.dataclass(frozen=True)
class MyriadArch:
    """Architecture dims for the composed model."""

    img_size: int = 224
    vit_patch: int = 14
    vit_dim: int = 1408
    vit_depth: int = 39
    vit_heads: int = 16
    vit_mlp_ratio: float = 4.3637
    num_query_token: int = 32
    qformer_hidden: int = 768
    qformer_layers: int = 12
    qformer_heads: int = 12
    qformer_intermediate: int = 3072
    adaptor_rank: int = 4
    map_size: int = 224
    llama: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
    imagebind: ImageBindConfig = dataclasses.field(default_factory=ImageBindConfig)

    @staticmethod
    def full(**overrides) -> "MyriadArch":
        return dataclasses.replace(MyriadArch(), **overrides)

    @staticmethod
    def tiny(**overrides) -> "MyriadArch":
        base = MyriadArch(img_size=28, vit_patch=14, vit_dim=32, vit_depth=2, vit_heads=4,
                          vit_mlp_ratio=4.0, num_query_token=8, qformer_hidden=16,
                          qformer_layers=2, qformer_heads=2, qformer_intermediate=32,
                          adaptor_rank=2, map_size=224, llama=LlamaConfig.tiny(),
                          imagebind=ImageBindConfig.tiny(img_size=28))
        return dataclasses.replace(base, **overrides)


class MyriadModule(nn.Module):
    """The weights and the compute of the composed model (no host state)."""

    def __init__(self, arch: MyriadArch, *, policy: Policy, device,
                 use_grad_checkpoint: bool = False):
        super().__init__()
        a = arch
        self.arch = arch
        self.dtype = policy.compute_dtype
        kw = dict(policy=policy, device=device)
        self.visual_encoder = EvaViT(img_size=a.img_size, patch_size=a.vit_patch,
                                     embed_dim=a.vit_dim, depth=a.vit_depth,
                                     num_heads=a.vit_heads, mlp_ratio=a.vit_mlp_ratio,
                                     use_checkpoint=use_grad_checkpoint, **kw)
        self.expert_adaptor = LoraAdaptorV2(dims=a.vit_dim, input_dim=a.adaptor_rank, **kw)
        self.ln_vision = LayerNormFp32(a.vit_dim, eps=1e-5, **kw)
        self.qformer = QFormer(hidden_size=a.qformer_hidden, encoder_dim=a.vit_dim,
                               num_layers=a.qformer_layers, num_heads=a.qformer_heads,
                               intermediate_size=a.qformer_intermediate, **kw)
        self.query_tokens = new_param((1, a.num_query_token, a.qformer_hidden),
                                      policy.param_dtype, device)
        self.ve_instructor = VEInstructorV2(out_dim=a.qformer_hidden, **kw)
        self.ve_tokenizer = VETokenizer(llm_dim=a.llama.hidden_size, **kw)
        self.llama_proj = Dense(a.qformer_hidden, a.llama.hidden_size, **kw)
        self.llama = LlamaForCausalLM(a.llama, **kw)

    def encode_img(self, image: torch.Tensor, maps: torch.Tensor, stage: int) -> torch.Tensor:
        if image.dtype == torch.uint8:
            image = u8_normalize(image, out_dtype=self.dtype)
        b = image.shape[0]
        feats = self.ln_vision(self.expert_adaptor(self.visual_encoder(image)))
        q = self.query_tokens.to(feats.dtype).expand(b, -1, -1)
        if stage in (1, 2):
            q = torch.cat([q, self.ve_instructor(maps)], dim=1)
        inputs_llama = self.llama_proj(self.qformer(q, feats))
        if stage in (0, 1):
            inputs_llama = torch.cat([inputs_llama, self.ve_tokenizer(maps)], dim=1)
        return inputs_llama

    def image_tokens(self, stage: int) -> int:
        """Positions ``encode_img`` gives an image, known before it runs: the
        queries, the VEInstructor's tokens (stages 1-2: one a cell of the map
        pyramid's (map_size / 32)^2 grid) and the VETokenizer's (stages 0-1:
        9 base prompts and its 5x5 head's 9 cells on that grid)."""
        side = self.arch.map_size // 32
        n = self.arch.num_query_token
        if stage in (1, 2):
            n += side * side
        if stage in (0, 1):
            n += 9 + (side - 4) ** 2
        return n

    def embed_tokens(self, ids: torch.Tensor) -> torch.Tensor:
        return self.llama.embed(ids)

    def prefill_embeds(self, image: torch.Tensor, maps: torch.Tensor, before_ids: torch.Tensor,
                       after_ids: torch.Tensor, stage: int, bos_id: int = 1,
                       add_bos: bool = True) -> torch.Tensor:
        """[bos?][before][image tokens][after] embeddings; serving passes
        add_bos=False (the reference generates with no bos embedding)."""
        b = image.shape[0]
        img = self.encode_img(image, maps, stage)
        before = self.embed_tokens(before_ids[None].expand(b, -1))
        after = self.embed_tokens(after_ids[None].expand(b, -1))
        pieces = [before, img.to(before.dtype), after]
        if add_bos:
            bos = torch.full((b, 1), bos_id, dtype=torch.int64, device=before.device)
            pieces.insert(0, self.embed_tokens(bos))
        return torch.cat(pieces, dim=1)

    def train_logits(self, image: torch.Tensor, maps: torch.Tensor, before_ids: torch.Tensor,
                     after_ids: torch.Tensor, text_ids: torch.Tensor, text_mask: torch.Tensor,
                     stage: int, bos_id: int = 1,
                     add_bos: bool = True) -> Tuple[torch.Tensor, int]:
        """(fp32 logits (B, P + L, V), prefix length P) of the training
        forward: the prefix (a bos embedding when ``add_bos``), then the
        right-padded target text, through the LLaMA without a cache under the
        causal mask and the text's key-padding mask."""
        prefix = self.prefill_embeds(image, maps, before_ids, after_ids, stage, bos_id,
                                     add_bos=add_bos)
        b, p, _ = prefix.shape
        text = self.embed_tokens(text_ids)
        inputs = torch.cat([prefix, text.to(prefix.dtype)], dim=1)
        attention_mask = torch.cat(
            [torch.ones((b, p), dtype=torch.int32, device=prefix.device),
             text_mask.to(torch.int32)], dim=1)
        return self.llama(inputs, None, attention_mask=attention_mask), p

    def forward_train(self, image: torch.Tensor, maps: torch.Tensor, before_ids: torch.Tensor,
                      after_ids: torch.Tensor, text_ids: torch.Tensor, text_mask: torch.Tensor,
                      stage: int, bos_id: int = 1, add_bos: bool = True) -> torch.Tensor:
        """The training loss: fp32 cross entropy of the target text, the
        prefix and the padding masked out (-100)."""
        logits, p = self.train_logits(image, maps, before_ids, after_ids, text_ids, text_mask,
                                      stage, bos_id, add_bos=add_bos)
        b = image.shape[0]
        ignore = torch.full((b, p), -100, dtype=torch.int64, device=logits.device)
        text_targets = torch.where(text_mask.bool(), text_ids.long(),
                                   torch.full_like(text_ids.long(), -100))
        return lm_cross_entropy(logits, torch.cat([ignore, text_targets], dim=1))


def _bf16_or_unset(value) -> bool:
    return not value or value == "bf16"


# config keys whose other values the port does not serve: the int8 towers,
# one-shot maps, a model without the vision expert, and what the JAX
# from_config would load: npz towers, a local Q-Former file, a checkpoint
# that the port's own CheckpointManager did not write and (from an existing
# path) an HF tokenizer
UNSERVED_KEYS = {
    "qformer_weight_dtype": _bf16_or_unset,
    "vit_weight_dtype": _bf16_or_unset,
    "ve_weight_dtype": _bf16_or_unset,
    "k_shot": lambda v: not v,
    "use_ve": lambda v: bool(v),
    "weights": lambda v: not v,
    "ckpt": lambda v: not v or ckpt_lib.is_port_checkpoint(str(v)),
    "q_former_model": lambda v: not v or not os.path.isfile(str(v)),
    "llama_model": lambda v: not v or not os.path.exists(str(v)),
}


def policy_from_config(cfg: Mapping) -> Optional[Policy]:
    """``param_policy`` ("fp32", "bf16" or "bf16_params") or, without it,
    ``vit_precision`` ("fp32" -> fp32, any other value -> bf16), as the JAX
    package reads them; None when the config has neither."""
    name = cfg.get("param_policy")
    if name:
        if name not in ("fp32", "bf16", "bf16_params"):
            raise ValueError(f"param_policy {name!r}: expected fp32, bf16 or bf16_params")
        return getattr(Policy, name)()
    if "vit_precision" in cfg:
        return Policy.fp32() if cfg["vit_precision"] == "fp32" else Policy.bf16()
    return None


class Myriad:
    """Host class: the module, the vision expert, prompt ids and ``generate``."""

    def __init__(self, arch: Optional[MyriadArch] = None, *, policy: Optional[Policy] = None,
                 device="cuda", prefill_chunks: int = 1, staged_decode: bool = False,
                 cache_granularity: int = 32, spec_k: int = 0, end_sym: str = "\n",
                 bos_at_generate: bool = False,
                 class_names: Optional[Sequence[str]] = None, freeze_vit: bool = True,
                 freeze_qformer: bool = True, freeze_llama: bool = True,
                 use_lora: bool = False, use_grad_checkpoint: bool = False,
                 max_txt_len: int = 32, train_llm_head: bool = False,
                 train_add_bos: bool = True, training: bool = False):
        self.arch = arch or MyriadArch.full()
        llama = self.arch.llama
        if use_lora:
            llama = dataclasses.replace(llama, use_lora=True)
        if use_grad_checkpoint:
            llama = dataclasses.replace(llama, remat=True)
        self.arch = dataclasses.replace(self.arch, llama=llama)
        self.policy = policy or Policy.bf16_params()
        self.device = torch.device(device)
        self.prefill_chunks = int(prefill_chunks)
        self.staged_decode = bool(staged_decode)
        self.cache_granularity = int(cache_granularity)
        # speculative decoding: verify spec_k drafted tokens per weight pass
        # (transcript-exact); 0 = plain greedy
        self.spec_k = int(spec_k)
        self.end_sym = end_sym
        # the reference generates with no bos embedding; True prepends one
        self.bos_at_generate = bool(bos_at_generate)
        self.freeze_vit, self.freeze_qformer = bool(freeze_vit), bool(freeze_qformer)
        self.freeze_llama, self.use_lora = bool(freeze_llama), bool(use_lora)
        self.train_llm_head = bool(train_llm_head)
        # training prepends a bos embedding, as the reference's training does
        self.train_add_bos = bool(train_add_bos)
        self.max_txt_len = int(max_txt_len)
        # frozen float parameters stored in the compute dtype (the JAX
        # package's _cast_frozen): build in it, then raise the trainables and
        # the LayerNorm scales to the parameter dtype
        build = Policy(self.policy.compute_dtype, self.policy.compute_dtype)
        self.module = MyriadModule(self.arch, policy=build, device=self.device,
                                   use_grad_checkpoint=use_grad_checkpoint)
        self.llama_tokenizer = ByteTokenizer()
        ve_module = AnomalyExpertModule(self.arch.imagebind, map_size=self.arch.map_size,
                                        policy=build, device=self.device)
        self.vision_expert = VisionExpert(
            ve_module, tokenizer=HashTokenizer(self.arch.imagebind.vocab_size),
            class_names=class_names)
        self.training = bool(training)
        self.ckpt_path = ""  # a port checkpoint merged over the trainables (from_config)
        self.trainable_names: List[str] = self._split_trainable()
        self._prompt_cache: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    # -- the trainable / frozen split ------------------------------------------
    def trainable_predicate(self) -> Callable[[str], bool]:
        """Whether a parameter (by its state-dict name) trains: the JAX
        package's ``_trainable_predicate`` over the same module paths."""

        def pred(name: str) -> bool:
            if name.startswith(("expert_adaptor", "ve_instructor", "ve_tokenizer")):
                return True
            if self.use_lora and re.search(r"lora_[ab]", name):
                return True
            if self.train_llm_head and name.startswith("llama.lm_head"):
                return True
            if not self.freeze_qformer and (name.startswith("qformer")
                                            or name == "query_tokens"):
                return True
            if not self.freeze_vit and name.startswith("visual_encoder"):
                return True
            return (not self.freeze_llama and not self.use_lora and name.startswith("llama")
                    and not name.startswith("llama_proj"))

        return pred

    def _split_trainable(self) -> List[str]:
        """Give the trainables (and LayerNorm scales) the parameter dtype and,
        when training, ``requires_grad``; returns the trainable names."""
        pred = self.trainable_predicate()
        param_dtype = self.policy.param_dtype
        scales = {id(m.weight) for mod in (self.module, self.vision_expert.module)
                  for m in mod.modules() if isinstance(m, LayerNorm)}
        names = []
        for mod, prefix in ((self.module, ""), (self.vision_expert.module, None)):
            for name, p in mod.named_parameters():
                train = prefix is not None and pred(name)
                if (train or id(p) in scales) and p.dtype != param_dtype:
                    p.data = p.data.to(param_dtype)
                p.requires_grad_(train and self.training)
                if train:
                    names.append(name)
        return names

    def trainable_state_dict(self) -> Dict[str, torch.Tensor]:
        params = dict(self.module.named_parameters())
        return {n: params[n] for n in self.trainable_names}

    def trainable_parameters(self) -> List[Tuple[str, nn.Parameter]]:
        params = dict(self.module.named_parameters())
        return [(n, params[n]) for n in self.trainable_names]

    @torch.no_grad()
    def load_checkpoint(self, path: str) -> Tuple[List[str], List[str]]:
        """Merge a checkpoint that the port's ``CheckpointManager`` wrote into
        the trainables, as the JAX ``load_checkpoint`` merges (strict=False:
        unknown names ignored, missing ones kept).  Returns (loaded, skipped)."""
        state = ckpt_lib.load_checkpoint(path)
        loaded, skipped = ckpt_lib.merge_into(self.trainable_state_dict(), state["model"])
        if not loaded:
            logging.warning("load checkpoint from %s matched no trainable parameter", path)
        logging.info("load checkpoint from %s (%d loaded, %d unknown)", path, len(loaded),
                     len(skipped))
        return loaded, skipped

    @classmethod
    def from_config(cls, cfg: Mapping, *, device="cuda", policy: Optional[Policy] = None,
                    class_names: Optional[Sequence[str]] = None,
                    training: bool = False) -> "Myriad":
        """Build from the JAX package's config keys, read as ``Myriad.from_config``
        there reads them: arch_preset, image_size, num_query_token (full
        preset only), llm_vocab_size, llm_weight_dtype (int8 when unset and
        low_resource), llm_kv_dtype or its alias kv_cache_dtype, use_lora
        (the q/v LoRA pair), llm_prefill_chunks, llm_staged_decode, llm_cache_granularity,
        llm_spec_k, end_sym, bos_at_generate, and param_policy or
        vit_precision (``policy`` wins when given; with none of the three the
        port serves bf16 storage, ``Policy.bf16_params``), and the keys that
        change training: freeze_vit, freeze_qformer, freeze_llama,
        train_llm_head, train_add_bos, use_grad_checkpoint and max_txt_len.
        Keys the port cannot serve raise ``NotImplementedError``; the
        reference's dead knobs (noise_level, ...) and ``prompt_path`` (a
        prompt list no step reads) are accepted and inactive.  ``ckpt`` naming a checkpoint that the
        port's ``CheckpointManager`` wrote is merged into the trainables
        (again after ``init_random`` or ``load_state_dicts``, as the JAX
        from_config merges it after its seeded initialisation); ``weights``,
        any other ``ckpt``, a ``q_former_model`` that names a local file and a
        ``llama_model`` that names an existing path raise."""
        for key, ok in UNSERVED_KEYS.items():
            if key in cfg and not ok(cfg[key]):
                raise NotImplementedError(f"config {key}={cfg[key]!r} is not ported")
        preset = cfg.get("arch_preset", "full")
        arch = MyriadArch.tiny() if preset == "tiny" else MyriadArch.full()
        if cfg.get("image_size"):
            arch = dataclasses.replace(arch, img_size=int(cfg["image_size"]))
        if cfg.get("num_query_token") and preset == "full":
            arch = dataclasses.replace(arch, num_query_token=int(cfg["num_query_token"]))
        llama = arch.llama
        if cfg.get("llm_vocab_size"):
            llama = dataclasses.replace(llama, vocab_size=int(cfg["llm_vocab_size"]))
        weight_dtype = cfg.get("llm_weight_dtype")
        if cfg.get("low_resource") and not weight_dtype:
            # the reference's 8-bit knob maps to int8 weight-only serving
            weight_dtype = "int8"
        if weight_dtype:
            llama = dataclasses.replace(llama, weight_dtype=weight_dtype)
        kv_dtype = cfg.get("llm_kv_dtype") or cfg.get("kv_cache_dtype")
        if kv_dtype:
            llama = dataclasses.replace(llama, kv_cache_dtype=kv_dtype)
        if cfg.get("use_lora"):
            llama = dataclasses.replace(llama, use_lora=True)
        model = cls(dataclasses.replace(arch, llama=llama),
                    policy=policy or policy_from_config(cfg), device=device,
                    prefill_chunks=cfg.get("llm_prefill_chunks", 1),
                    staged_decode=cfg.get("llm_staged_decode", True),
                    cache_granularity=cfg.get("llm_cache_granularity", 32),
                    spec_k=cfg.get("llm_spec_k", 0), end_sym=cfg.get("end_sym", "\n"),
                    bos_at_generate=cfg.get("bos_at_generate", False),
                    class_names=class_names, freeze_vit=cfg.get("freeze_vit", True),
                    freeze_qformer=cfg.get("freeze_qformer", True),
                    freeze_llama=cfg.get("freeze_llama", True),
                    use_lora=cfg.get("use_lora", False),
                    use_grad_checkpoint=cfg.get("use_grad_checkpoint", False),
                    max_txt_len=cfg.get("max_txt_len", 32),
                    train_llm_head=cfg.get("train_llm_head", False),
                    train_add_bos=cfg.get("train_add_bos", True), training=training)
        model.ckpt_path = str(cfg.get("ckpt") or "")
        model._merge_ckpt()
        return model

    # -- weights --------------------------------------------------------------
    def load_state_dicts(self, model_sd: Mapping[str, torch.Tensor],
                         ve_sd: Mapping[str, torch.Tensor]) -> None:
        """Load with strict=True: every leaf accounted for in both directions."""
        self.module.load_state_dict(model_sd, strict=True)
        self.vision_expert.module.load_state_dict(ve_sd, strict=True)
        self.vision_expert._text_feats = None
        self._merge_ckpt()

    def init_random(self, seed: int) -> None:
        """Seeded random weights, drawn on the model's device."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        init_random_(self.module, gen)
        init_random_(self.vision_expert.module, gen)
        self.vision_expert._text_feats = None
        self._merge_ckpt()

    def _merge_ckpt(self) -> None:
        if getattr(self, "ckpt_path", ""):
            self.load_checkpoint(self.ckpt_path)

    # -- host-side text plumbing ----------------------------------------------
    def split_prompt(self, question: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """'###Human: ' + q + ' ###Assistant: ' split at <ImageHere>, tokenised once."""
        prompt = "###Human: " + question + " ###Assistant: "
        if prompt not in self._prompt_cache:
            before, after = prompt.split("<ImageHere>")
            ids = []
            for piece in (before, after):
                tok = self.llama_tokenizer(piece, add_special_tokens=False)["input_ids"]
                tok = tok[0] if tok and isinstance(tok[0], list) else tok
                ids.append(torch.tensor(tok, dtype=torch.int64, device=self.device))
            self._prompt_cache[prompt] = (ids[0], ids[1])
        return self._prompt_cache[prompt]

    # -- sample prep ----------------------------------------------------------
    def prepare_sample(self, samples: Dict, stage: int, training: bool = False):
        """(image, question, texts, maps, one_maps) for a batch: the zero-shot
        maps of the vision expert; one_maps are the same maps, as the JAX
        package gives them when no reference bank is built.  ``training``
        appends the augmented twins (``aug_image``, their scenes) and takes
        the target texts (``text_input`` then ``aug_text_input``)."""
        image = samples["image"]
        image = (image if torch.is_tensor(image)
                 else torch.as_tensor(np.asarray(image))).to(self.device)
        if image.dtype != torch.uint8:
            image = image.float()
        scenes = list(samples["scene"])
        texts = None
        if training and "aug_image" in samples:
            aug = samples["aug_image"]
            aug = (aug if torch.is_tensor(aug) else torch.as_tensor(np.asarray(aug)))
            image = torch.cat([image, aug.to(device=self.device, dtype=image.dtype)])
            scenes = scenes + scenes
        if training and "text_input" in samples:
            texts = list(samples["text_input"]) + list(samples.get("aug_text_input", []))
        q_key = {0: "question", 1: "question2", 2: "question3"}[stage]
        questions = samples.get(q_key) or samples.get("question")
        question = questions[0] if isinstance(questions, (list, tuple)) else questions
        maps, _ = self.vision_expert(image, scenes)
        if training:
            maps = maps.clone()  # out of inference mode: the map encoders train on it
        return image, question, texts, maps, maps

    def tokenize_targets(self, texts: Sequence[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ids, mask) (B, max_txt_len): each text and ``end_sym`` tokenised,
        cut to ``max_txt_len`` and right-padded with 0."""
        ln = self.max_txt_len
        ids = np.zeros((len(texts), ln), np.int64)
        mask = np.zeros((len(texts), ln), np.int64)
        for i, t in enumerate(texts):
            row = self.llama_tokenizer(t + self.end_sym, add_special_tokens=False)["input_ids"]
            row = list(row[0] if row and isinstance(row[0], list) else row)[:ln]
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return (torch.as_tensor(ids, device=self.device),
                torch.as_tensor(mask, device=self.device))

    # -- training ---------------------------------------------------------------
    def prepare_train_arrays(self, samples: Dict, rng: np.random.Generator):
        """A training batch's tensors and its static stage: the prompt stage
        and the task stage drawn from ``rng`` (in that order, as the JAX
        package draws them), the vision expert's maps, the prompt's pieces and
        the tokenised targets."""
        stage = int(rng.integers(0, 3))
        task = int(rng.integers(0, 2))
        image, question, texts, maps, one_maps = self.prepare_sample(samples, stage,
                                                                     training=True)
        before, after = self.split_prompt(question)
        text_ids, text_mask = self.tokenize_targets(texts)
        arrays = {"image": image, "maps": one_maps if task == 1 else maps, "before": before,
                  "after": after, "text_ids": text_ids, "text_mask": text_mask}
        return arrays, (stage,)

    def train_loss(self, arrays: Dict[str, torch.Tensor], static: Tuple[int]) -> torch.Tensor:
        """The loss of one batch (the JAX package's ``pure_loss`` over the
        module's own parameters)."""
        (stage,) = static
        return self.module.forward_train(arrays["image"], arrays["maps"], arrays["before"],
                                         arrays["after"], arrays["text_ids"],
                                         arrays["text_mask"], stage, add_bos=self.train_add_bos)

    def forward(self, samples: Dict, rng: Optional[np.random.Generator] = None) -> Dict:
        """One training loss with a random prompt and task stage."""
        arrays, static = self.prepare_train_arrays(samples, rng or np.random.default_rng())
        return {"loss": self.train_loss(arrays, static)}

    # -- serving --------------------------------------------------------------
    def _spec_lookup_ids(self, after: torch.Tensor) -> torch.Tensor:
        """Lookup corpus for prompt-lookup speculative decoding: the
        post-image prompt ids, then the task's templated answers (real
        transcripts open with one of them), each followed by ``end_sym``."""
        ids = [int(i) for i in torch.as_tensor(after).reshape(-1).tolist()]
        for text in (NORMAL_DESCRIBE, ABNORMAL_DESCRIBE):
            t_ids = self.llama_tokenizer(text + self.end_sym,
                                         add_special_tokens=False)["input_ids"]
            if t_ids and isinstance(t_ids[0], list):
                t_ids = t_ids[0]
            ids.extend(int(i) for i in t_ids)
        return torch.tensor(ids, dtype=torch.int64, device=self.device)

    def _decode_fn(self, gen_cfg: GenerationConfig, cache_dtype, lookup_ids):
        """``greedy_generate``, or its speculative twin when spec_k > 0 and
        decoding is greedy: a function embeds -> (tokens, stats), stats being
        the acceptance counters ({} on the plain path)."""
        llama = self.module.llama
        if self.spec_k > 0 and not gen_cfg.do_sample:
            return lambda embeds: speculative_generate(
                llama, embeds, config=gen_cfg, spec_k=self.spec_k, lookup_ids=lookup_ids,
                cache_dtype=cache_dtype, return_stats=True)
        return lambda embeds: (greedy_generate(llama, embeds, config=gen_cfg,
                                               cache_dtype=cache_dtype), {})

    def generate(self, samples: Dict, **generate_kwargs) -> Dict:
        """Greedy (or speculative, ``spec_k > 0``) decode of the AQA answer
        for a batch of images; ``spec_stats`` joins the result on the
        speculative path."""
        defaults = GenerationConfig()
        gen_cfg = GenerationConfig(
            max_new_tokens=generate_kwargs.get("max_new_tokens", 90),
            do_sample=generate_kwargs.get("do_sample", False),
            top_p=generate_kwargs.get("top_p", 0.01),
            temperature=generate_kwargs.get("temperature", 1.0),
            eos_token_id=generate_kwargs.get("eos_token_id", defaults.eos_token_id),
            pad_token_id=generate_kwargs.get("pad_token_id", defaults.pad_token_id),
            stop_single=generate_kwargs.get("stop_single", defaults.stop_single),
            stop_pair=tuple(generate_kwargs.get("stop_pair", defaults.stop_pair)),
            prefill_chunks=generate_kwargs.get("prefill_chunks", self.prefill_chunks),
            staged_decode=generate_kwargs.get("staged_decode", self.staged_decode),
            cache_granularity=generate_kwargs.get("cache_granularity",
                                                  self.cache_granularity),
        )
        if gen_cfg.do_sample and gen_cfg.top_p <= 0.01 and gen_cfg.temperature <= 1.0:
            # the reference's shipped kwargs (do_sample, top_p=0.01, T=1) are
            # greedy in effect: route them to the deterministic greedy path,
            # where speculative decoding (spec_k) engages
            gen_cfg = dataclasses.replace(gen_cfg, do_sample=False)
        if gen_cfg.do_sample:
            raise NotImplementedError("top-p sampling is not ported; greedy only")
        return self._generate_fused(samples, 1, gen_cfg)

    @torch.inference_mode()
    def _generate_fused(self, samples: Dict, stage: int, gen_cfg: GenerationConfig) -> Dict:
        """VE zero-shot maps + encode_img + prefill + decode."""
        image, question, _, maps, _ = self.prepare_sample(samples, stage)
        before, after = self.split_prompt(question)
        # served with no bos embedding, as the reference generates, unless
        # bos_at_generate
        embeds = self.module.prefill_embeds(image, maps, before, after, stage,
                                            add_bos=self.bos_at_generate)
        cache_dtype = serving_cache_dtype(self.arch.llama, self.policy.compute_dtype)
        lookup = self._spec_lookup_ids(after) if self.spec_k > 0 else None
        tokens, stats = self._decode_fn(gen_cfg, cache_dtype, lookup)(embeds)
        out = {"token_ids": tokens, "ve_anomaly_maps": maps}
        if stats:
            out["spec_stats"] = stats
        return out
