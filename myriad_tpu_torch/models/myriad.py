"""Myriad, the composed IAD vision-language model, for serving (counterpart of
``myriad_tpu/models/myriad.py``).

    EVA-ViT-g -> LoraAdaptorV2 -> ln_vision -> Q-Former (32 queries + 49
    VEInstructor tokens) -> llama_proj [+ 18 VETokenizer tokens] -> Vicuna-7B

with the ImageBind vision expert producing the anomaly maps that feed the
two map encoders.  ``MyriadModule`` holds the weights and the compute;
``Myriad`` is the host class: prompt tokenisation, the vision expert's
text-feature cache, and ``generate`` (greedy, or speculative when
``spec_k > 0``).  The serving path is zero-shot; one-shot maps, top-p
sampling and training are not ported yet.  ``Myriad`` builds on the card
unless the caller passes another device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from myriad_tpu_torch.datasets.anomaly_detection import ABNORMAL_DESCRIBE, NORMAL_DESCRIBE
from myriad_tpu_torch.generation import (GenerationConfig, greedy_generate,
                                         speculative_generate)
from myriad_tpu_torch.models.clip_tokenizer import HashTokenizer
from myriad_tpu_torch.models.eva_vit import EvaViT
from myriad_tpu_torch.models.imagebind import ImageBindConfig
from myriad_tpu_torch.models.layers import Dense, LayerNormFp32, Policy, init_random_, new_param
from myriad_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
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

    def __init__(self, arch: MyriadArch, *, policy: Policy, device):
        super().__init__()
        a = arch
        self.arch = arch
        self.dtype = policy.compute_dtype
        kw = dict(policy=policy, device=device)
        self.visual_encoder = EvaViT(img_size=a.img_size, patch_size=a.vit_patch,
                                     embed_dim=a.vit_dim, depth=a.vit_depth,
                                     num_heads=a.vit_heads, mlp_ratio=a.vit_mlp_ratio, **kw)
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


def _bf16_or_unset(value) -> bool:
    return not value or value == "bf16"


# config keys whose other values the port does not serve: the int8 towers,
# one-shot maps, a model without the vision expert, and what the JAX
# from_config would load: npz towers, a local Q-Former file, a checkpoint and
# (from an existing path) an HF tokenizer
UNSERVED_KEYS = {
    "qformer_weight_dtype": _bf16_or_unset,
    "vit_weight_dtype": _bf16_or_unset,
    "ve_weight_dtype": _bf16_or_unset,
    "k_shot": lambda v: not v,
    "use_ve": lambda v: bool(v),
    "weights": lambda v: not v,
    "ckpt": lambda v: not v,
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
                 class_names: Optional[Sequence[str]] = None):
        self.arch = arch or MyriadArch.full()
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
        self.module = MyriadModule(self.arch, policy=self.policy, device=self.device)
        self.llama_tokenizer = ByteTokenizer()
        ve_module = AnomalyExpertModule(self.arch.imagebind, map_size=self.arch.map_size,
                                        policy=self.policy, device=self.device)
        self.vision_expert = VisionExpert(
            ve_module, tokenizer=HashTokenizer(self.arch.imagebind.vocab_size),
            class_names=class_names)
        self._prompt_cache: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    @classmethod
    def from_config(cls, cfg: Mapping, *, device="cuda", policy: Optional[Policy] = None,
                    class_names: Optional[Sequence[str]] = None) -> "Myriad":
        """Build from the JAX package's config keys, read as ``Myriad.from_config``
        there reads them: arch_preset, image_size, num_query_token (full
        preset only), llm_vocab_size, llm_weight_dtype (int8 when unset and
        low_resource), llm_kv_dtype or its alias kv_cache_dtype, use_lora
        (the q/v LoRA pair), llm_prefill_chunks, llm_staged_decode, llm_cache_granularity,
        llm_spec_k, end_sym, bos_at_generate, and param_policy or
        vit_precision (``policy`` wins when given; with none of the three the
        port serves bf16 storage, ``Policy.bf16_params``).  Keys the port
        cannot serve raise ``NotImplementedError``; the reference's dead
        knobs (noise_level, ...) and the training keys are accepted and
        inactive.  No weights are loaded: ``weights``, ``ckpt``, a
        ``q_former_model`` that names a local file and a ``llama_model`` that
        names an existing path raise."""
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
        return cls(dataclasses.replace(arch, llama=llama),
                   policy=policy or policy_from_config(cfg), device=device,
                   prefill_chunks=cfg.get("llm_prefill_chunks", 1),
                   staged_decode=cfg.get("llm_staged_decode", True),
                   cache_granularity=cfg.get("llm_cache_granularity", 32),
                   spec_k=cfg.get("llm_spec_k", 0), end_sym=cfg.get("end_sym", "\n"),
                   bos_at_generate=cfg.get("bos_at_generate", False),
                   class_names=class_names)

    # -- weights --------------------------------------------------------------
    def load_state_dicts(self, model_sd: Mapping[str, torch.Tensor],
                         ve_sd: Mapping[str, torch.Tensor]) -> None:
        """Load with strict=True: every leaf accounted for in both directions."""
        self.module.load_state_dict(model_sd, strict=True)
        self.vision_expert.module.load_state_dict(ve_sd, strict=True)
        self.vision_expert._text_feats = None

    def init_random(self, seed: int) -> None:
        """Seeded random weights, drawn on the model's device."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        init_random_(self.module, gen)
        init_random_(self.vision_expert.module, gen)
        self.vision_expert._text_feats = None

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
        """(image, question, texts, maps, one_maps) for a serving batch: the
        zero-shot maps of the vision expert; one_maps are the same maps, as
        the JAX package gives them when no reference bank is built.  The
        training case (augmented images, targets) is not ported."""
        if training:
            raise NotImplementedError("training sample prep is not ported")
        image = samples["image"]
        image = (image if torch.is_tensor(image)
                 else torch.as_tensor(np.asarray(image))).to(self.device)
        if image.dtype != torch.uint8:
            image = image.float()
        q_key = {0: "question", 1: "question2", 2: "question3"}[stage]
        questions = samples.get(q_key) or samples.get("question")
        question = questions[0] if isinstance(questions, (list, tuple)) else questions
        maps, _ = self.vision_expert(image, list(samples["scene"]))
        return image, question, None, maps, maps

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
