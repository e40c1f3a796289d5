"""Myriad, the composed IAD vision-language model, for serving (counterpart of
``myriad_tpu/models/myriad.py``).

    EVA-ViT-g -> LoraAdaptorV2 -> ln_vision -> Q-Former (32 queries + 49
    VEInstructor tokens) -> llama_proj [+ 18 VETokenizer tokens] -> Vicuna-7B

with the ImageBind vision expert producing the anomaly maps that feed the
two map encoders.  ``MyriadModule`` holds the weights and the compute;
``Myriad`` is the host class: prompt tokenisation, the vision expert's
text-feature cache, and ``generate``.  The serving path is zero-shot and
greedy; one-shot maps, top-p sampling and training are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from myriad_tpu_torch.generation import GenerationConfig, greedy_generate
from myriad_tpu_torch.models.eva_vit import EvaViT
from myriad_tpu_torch.models.imagebind import ImageBindConfig
from myriad_tpu_torch.models.layers import Dense, LayerNormFp32, Policy, init_random_, new_param
from myriad_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           serving_cache_dtype)
from myriad_tpu_torch.models.networks import LoraAdaptorV2, VEInstructorV2, VETokenizer
from myriad_tpu_torch.models.qformer import QFormer
from myriad_tpu_torch.models.vision_expert import (AnomalyExpertModule, VisionExpert,
                                                   hash_tokenizer)
from myriad_tpu_torch.ops.preprocess import u8_normalize


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


def _byte_tokenizer():
    from myriad_tpu.tokenization import ByteTokenizer  # jax-free module

    return ByteTokenizer()


class Myriad:
    """Host class: the module, the vision expert, prompt ids and ``generate``."""

    def __init__(self, arch: Optional[MyriadArch] = None, *, policy: Optional[Policy] = None,
                 device="cpu", prefill_chunks: int = 1, staged_decode: bool = False,
                 cache_granularity: int = 32, class_names: Optional[Sequence[str]] = None):
        self.arch = arch or MyriadArch.full()
        self.policy = policy or Policy.bf16_params()
        self.device = torch.device(device)
        self.prefill_chunks = int(prefill_chunks)
        self.staged_decode = bool(staged_decode)
        self.cache_granularity = int(cache_granularity)
        self.module = MyriadModule(self.arch, policy=self.policy, device=self.device)
        self.llama_tokenizer = _byte_tokenizer()
        ve_module = AnomalyExpertModule(self.arch.imagebind, map_size=self.arch.map_size,
                                        policy=self.policy, device=self.device)
        self.vision_expert = VisionExpert(
            ve_module, tokenizer=hash_tokenizer(self.arch.imagebind.vocab_size),
            class_names=class_names)
        self._prompt_cache: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    @classmethod
    def from_config(cls, cfg: Mapping, *, device="cpu", policy: Optional[Policy] = None,
                    class_names: Optional[Sequence[str]] = None) -> "Myriad":
        """Build from the JAX package's config keys that the serving profile
        reads: arch_preset, llm_weight_dtype, llm_kv_dtype,
        llm_prefill_chunks, llm_staged_decode, llm_cache_granularity."""
        if cfg.get("k_shot", 0) > 0:
            raise NotImplementedError("one-shot anomaly maps (k_shot > 0) are not ported")
        arch = MyriadArch.tiny() if cfg.get("arch_preset", "full") == "tiny" else MyriadArch.full()
        llama = arch.llama
        if cfg.get("llm_weight_dtype"):
            llama = dataclasses.replace(llama, weight_dtype=cfg["llm_weight_dtype"])
        if cfg.get("llm_kv_dtype"):
            llama = dataclasses.replace(llama, kv_cache_dtype=cfg["llm_kv_dtype"])
        return cls(dataclasses.replace(arch, llama=llama), policy=policy, device=device,
                   prefill_chunks=cfg.get("llm_prefill_chunks", 1),
                   staged_decode=cfg.get("llm_staged_decode", True),
                   cache_granularity=cfg.get("llm_cache_granularity", 32),
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

    # -- serving --------------------------------------------------------------
    def generate(self, samples: Dict, **generate_kwargs) -> Dict:
        """Greedy decode of the AQA answer for a batch of images."""
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
            # greedy in effect: route them to the deterministic greedy path
            gen_cfg = dataclasses.replace(gen_cfg, do_sample=False)
        if gen_cfg.do_sample:
            raise NotImplementedError("top-p sampling is not ported; greedy only")
        return self._generate_fused(samples, 1, gen_cfg)

    @torch.inference_mode()
    def _generate_fused(self, samples: Dict, stage: int, gen_cfg: GenerationConfig) -> Dict:
        """VE zero-shot maps + encode_img + prefill + decode."""
        ve = self.vision_expert
        image = torch.as_tensor(np.asarray(samples["image"])).to(self.device)
        if image.dtype != torch.uint8:
            image = image.float()
        q_key = {0: "question", 1: "question2", 2: "question3"}[stage]
        questions = samples.get(q_key) or samples.get("question")
        question = questions[0] if isinstance(questions, (list, tuple)) else questions
        before, after = self.split_prompt(question)
        if ve._text_feats is None:
            ve.build_text_features()
        text_feats = ve._text_feats[ve.scene_ids(list(samples["scene"]))]
        maps, _ = ve.module.zero_shot(image, text_feats)
        # served with no bos embedding, as the reference generates
        embeds = self.module.prefill_embeds(image, maps, before, after, stage, add_bos=False)
        cache_dtype = serving_cache_dtype(self.arch.llama, self.policy.compute_dtype)
        tokens = greedy_generate(self.module.llama, embeds, config=gen_cfg,
                                 cache_dtype=cache_dtype)
        return {"token_ids": tokens, "ve_anomaly_maps": maps}
