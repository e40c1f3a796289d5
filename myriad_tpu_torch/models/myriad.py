"""Myriad, the composed IAD vision-language model, for serving and training
(counterpart of ``myriad_tpu/models/myriad.py``).

    EVA-ViT-g -> LoraAdaptorV2 -> ln_vision -> Q-Former (32 queries + 49
    VEInstructor tokens) -> llama_proj [+ 18 VETokenizer tokens] -> Vicuna-7B

with the ImageBind vision expert producing the anomaly maps that feed the
two map encoders.  ``MyriadModule`` holds the weights and the compute;
``Myriad`` is the host class: prompt tokenisation, the vision expert (its
text-feature cache and one-shot reference bank, or another expert of the
mux, ``models/vision_experts.py``, or none), ``generate`` (greedy, top-p
sampling from a seeded ``torch.Generator``, or speculative when
``spec_k > 0``; one-shot maps when ``k_shot > 0`` and a bank is built), the
pretrained towers (``load_pretrained_weights``: converted npz trees,
quantized on load for the int8 towers and the int8 or int4 LLaMA) and the
training step's pieces (``prepare_train_arrays``, ``train_loss``,
``forward``).  The trainable parameters are chosen by name as the JAX
package's ``_trainable_predicate`` chooses its paths; under a policy with
fp32 parameters and bf16 compute (``Policy.bf16``, the JAX package's
default) the frozen float parameters are stored in bf16 and the trainables
and LayerNorm scales in fp32, as its ``_cast_frozen`` leaves them.  A model
built with ``training=True`` gives its trainables ``requires_grad``.
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
from myriad_tpu_torch.convert import convert_qformer_state_dict
from myriad_tpu_torch.convert_from_jax import jax_path_of
from myriad_tpu_torch.datasets.anomaly_detection import ABNORMAL_DESCRIBE, NORMAL_DESCRIBE
from myriad_tpu_torch.generation import (GenerationConfig, greedy_generate,
                                         speculative_generate)
from myriad_tpu_torch.models.clip_tokenizer import ClipBpeTokenizer, HashTokenizer
from myriad_tpu_torch.models.base import TrainableModel
from myriad_tpu_torch.models.eva_vit import EvaViT
from myriad_tpu_torch.models.imagebind import ImageBindConfig
from myriad_tpu_torch.models.layers import (Dense, LayerNormFp32, Policy,
                                            init_random_, new_param)
from myriad_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM, lm_cross_entropy,
                                           serving_cache_dtype)
from myriad_tpu_torch.models.networks import LoraAdaptorV2, VEInstructorV2, VETokenizer
from myriad_tpu_torch.models.qformer import QFormer
from myriad_tpu_torch.models.vision_expert import AnomalyExpertModule, VisionExpert
from myriad_tpu_torch.models.vision_experts import PrecomputedMaskExpert, build_vision_expert
from myriad_tpu_torch.ops import quant
from myriad_tpu_torch.ops.preprocess import u8_normalize
from myriad_tpu_torch.orbax_format.checkpointer import is_checkpoint as orbax_checkpoint
from myriad_tpu_torch.tokenization import load_llama_tokenizer


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
    # "int8": the frozen towers' projections quantized (QuantDense)
    vit_weight_dtype: str = "bf16"
    qformer_weight_dtype: str = "bf16"
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
                                     use_checkpoint=use_grad_checkpoint,
                                     weight_dtype=a.vit_weight_dtype, **kw)
        self.expert_adaptor = LoraAdaptorV2(dims=a.vit_dim, input_dim=a.adaptor_rank, **kw)
        self.ln_vision = LayerNormFp32(a.vit_dim, eps=1e-5, **kw)
        self.qformer = QFormer(hidden_size=a.qformer_hidden, encoder_dim=a.vit_dim,
                               num_layers=a.qformer_layers, num_heads=a.qformer_heads,
                               intermediate_size=a.qformer_intermediate,
                               weight_dtype=a.qformer_weight_dtype, **kw)
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


# config keys whose other values the port does not serve: a checkpoint that
# is neither an npz tree, an Orbax checkpoint directory nor the port's own
# earlier CheckpointManager file (another .pth, a directory without _METADATA)
UNSERVED_KEYS = {
    "ckpt": lambda v: (not v or str(v).endswith(".npz") or orbax_checkpoint(str(v))
                       or ckpt_lib.is_port_checkpoint(str(v))),
}
# the towers ``load_pretrained_weights`` reads, the root a tower-local tree
# merges under, and the projections an int8 tower quantizes
WEIGHT_TOWERS = ("vit", "qformer", "llama", "llama_proj", "imagebind", "decoder")
_TOWER_ROOT = {"vit": "visual_encoder", "llama": "llama", "decoder": "image_decoder"}
_TOWER_PATTERN = {"vit": quant.EVA_QUANT_PATTERN, "qformer": quant.QFORMER_QUANT_PATTERN,
                  "imagebind": quant.IMAGEBIND_QUANT_PATTERN}
# the frozen roots each tower covers (the missing-leaf accounting)
_COVERED_ROOTS = {"vit": ["visual_encoder"], "qformer": ["qformer", "query_tokens", "ln_vision"],
                  "llama": ["llama"], "llama_proj": ["llama_proj"],
                  "imagebind": ["ve/visual", "ve/text"], "decoder": ["ve/image_decoder"]}


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


class Myriad(TrainableModel):
    """Host class: the module, the vision expert, prompt ids and ``generate``.

    The LLaMA tokenizer is ``llama_model``'s (``load_llama_tokenizer``: a
    Vicuna directory's ``tokenizer.model``, else ``ByteTokenizer``).  The
    vision expert is built as the JAX package builds it: the ImageBind
    expert when ``use_ve`` and ``init_vision_expert`` (its CLIP tokenizer the
    BPE of ``clip_bpe_path`` when given, else the hash stand-in), none
    otherwise (the maps are zeros); ``vis_expert`` other than
    ``adrefexpert``/``patchcore`` puts another expert of the mux in front of
    it (``build_expert``).  ``k_shot > 0`` serves the one-shot maps once a
    reference bank is built (``evaluate.setup_vision_expert``)."""

    def __init__(self, arch: Optional[MyriadArch] = None, *, policy: Optional[Policy] = None,
                 device="cuda", llama_model: str = "", prefill_chunks: int = 1,
                 staged_decode: bool = False,
                 cache_granularity: int = 32, spec_k: int = 0, end_sym: str = "\n",
                 bos_at_generate: bool = False,
                 class_names: Optional[Sequence[str]] = None, freeze_vit: bool = True,
                 freeze_qformer: bool = True, freeze_llama: bool = True,
                 use_lora: bool = False, use_grad_checkpoint: bool = False,
                 max_txt_len: int = 32, train_llm_head: bool = False,
                 train_add_bos: bool = True, training: bool = False, use_ve: bool = True,
                 init_vision_expert: bool = True, clip_bpe_path: str = "",
                 vis_expert: Optional[str] = "adrefexpert",
                 vis_expert_args: Optional[Mapping] = None, k_shot: int = 0,
                 round_index: int = 0):
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
        self.k_shot, self.round_index = int(k_shot), int(round_index)
        # frozen float parameters stored in the compute dtype (the JAX
        # package's _cast_frozen): build in it, then raise the trainables and
        # the LayerNorm scales to the parameter dtype
        build = Policy(self.policy.compute_dtype, self.policy.compute_dtype)
        self.module = MyriadModule(self.arch, policy=build, device=self.device,
                                   use_grad_checkpoint=use_grad_checkpoint)
        self.llama_tokenizer = load_llama_tokenizer(llama_model)
        self.vision_expert: Optional[VisionExpert] = None
        if use_ve and init_vision_expert:
            ve_module = AnomalyExpertModule(self.arch.imagebind, map_size=self.arch.map_size,
                                            policy=build, device=self.device)
            tokenizer = (ClipBpeTokenizer(clip_bpe_path) if clip_bpe_path
                         else HashTokenizer(self.arch.imagebind.vocab_size))
            self.vision_expert = VisionExpert(ve_module, tokenizer=tokenizer,
                                              class_names=class_names)
        self.expert = self.build_expert(vis_expert, vis_expert_args)
        self.training = bool(training)
        # what from_config loads over every initialisation (init_random,
        # load_state_dicts): the pretrained towers, then a checkpoint
        self.weights: Dict = {}
        self.weights_report: Optional[Dict] = None
        self.ckpt_path = ""
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

    def split_modules(self):
        mods = [(self.module, True)]
        if self.vision_expert is not None:
            mods.append((self.vision_expert.module, False))
        return mods

    def build_expert(self, vis_expert: Optional[str], vis_expert_args: Optional[Mapping] = None):
        """The expert that serves the maps, as the JAX ``Myriad`` picks it:
        the ImageBind expert for ``adrefexpert``, ``patchcore``, "" or None;
        else ``vision_experts.build_vision_expert`` of the name, with
        ``vis_expert_args`` (``simplenet``: ``ckpt_root`` and an optional
        ``backbone`` npz; ``aprilgan``: ``ve_root``).  An unknown name raises
        ``KeyError``."""
        if vis_expert in ("adrefexpert", "patchcore", "", None):
            return self.vision_expert
        kwargs = dict(vis_expert_args or {})
        if vis_expert.lower() in ("simplenet", "simplenetv") and \
                "simplenet_interface" not in kwargs:
            from myriad_tpu_torch.models.simplenet import load_simplenet_interface

            kwargs["simplenet_interface"] = load_simplenet_interface(
                kwargs.pop("ckpt_root"), backbone_path=kwargs.pop("backbone", None),
                map_size=self.arch.map_size, device=self.device)
        kwargs.setdefault("adrefexpert", self.vision_expert)
        return build_vision_expert(vis_expert, device=self.device, **kwargs)

    # -- pretrained towers --------------------------------------------------------
    def _check_ve_weights(self, weights: Mapping) -> None:
        if (weights.get("imagebind") or weights.get("decoder")) and self.vision_expert is None:
            raise ValueError("imagebind/decoder weights given but use_ve=False")

    def _tower_tree(self, key: str, value) -> Dict:
        """A tower's tree, read when ``value`` is a path, converted from a raw
        BLIP-2 state dict, rooted where it merges and quantized as the model
        serves it (the JAX ``load_pretrained_weights`` steps, in its order)."""
        tree = dict(ckpt_lib.load_params(value) if isinstance(value, str) else value)
        if key == "qformer" and any("." in str(k) for k in tree):
            # a raw BLIP-2 torch checkpoint (flat 'Qformer.bert.*' names)
            prefix = ("Qformer.bert." if any(str(k).startswith("Qformer.") for k in tree)
                      else "bert.")
            tree = convert_qformer_state_dict(tree, num_layers=self.arch.qformer_layers,
                                              prefix=prefix)["params"]
        if key == "qformer" and "qformer" not in tree:
            # a tower-local tree: query_tokens and ln_vision travel with it
            rooted = {"qformer": {k: v for k, v in tree.items()
                                  if k not in ("query_tokens", "ln_vision")}}
            rooted.update({k: tree[k] for k in ("query_tokens", "ln_vision") if k in tree})
            tree = rooted
        a = self.arch
        if key == "llama" and a.llama.weight_dtype in ("int8", "int4"):
            tree = quant.quantize_tree(tree, mode=a.llama.weight_dtype)
        tower_dtype = {"vit": a.vit_weight_dtype, "qformer": a.qformer_weight_dtype,
                       "imagebind": a.imagebind.weight_dtype}.get(key)
        if tower_dtype == "int8":
            tree = quant.quantize_tree(tree, _TOWER_PATTERN[key])
        return {_TOWER_ROOT[key]: tree} if key in _TOWER_ROOT else tree

    @torch.no_grad()
    def load_pretrained_weights(self, weights: Mapping) -> Dict:
        """Merge converted pretrained towers into the frozen parameters, as
        the JAX ``load_pretrained_weights`` does: ``weights`` maps tower names
        (``WEIGHT_TOWERS``) to npz paths or loaded trees in the JAX layout;
        ``qformer`` may also be a raw BLIP-2 ``.pth`` (converted in place).
        Each int8 tower (and an int8 or int4 LLaMA) is quantized on load
        (``ops.quant.quantize_tree``).  Vision-expert towers on a model
        without the expert raise ``ValueError``.  Returns the report:
        ``loaded`` and ``skipped`` path lists by tower and ``missing``, the
        frozen leaves under the given towers' roots that none supplied."""
        for key in weights:
            if key not in WEIGHT_TOWERS:
                logging.warning("load_pretrained_weights: unknown tower '%s' (known: %s)", key,
                                WEIGHT_TOWERS)
        self._check_ve_weights(weights)
        report: Dict = {"loaded": {}, "skipped": {}}
        trainable = set(self.trainable_names)
        frozen = {n: t for n, t in self.module.state_dict().items() if n not in trainable}
        targets = [(("vit", "qformer", "llama", "llama_proj"), self.module, frozen, "")]
        ve = self.vision_expert
        if ve is not None:
            targets.append((("imagebind", "decoder"), ve.module, ve.module.state_dict(), "ve"))
        loaded_paths, paths = set(), []
        for keys, module, params, prefix in targets:
            for key in keys:
                if weights.get(key):
                    tree = self._tower_tree(key, weights[key])
                    loaded, skipped = ckpt_lib.merge_with_paths(params, tree, prefix=prefix)
                    report["loaded"][key], report["skipped"][key] = loaded, skipped
                    loaded_paths.update(loaded)
            paths += [f"{prefix}/{jax_path_of(module, n)}".lstrip("/") for n in params]
        if ve is not None and ("imagebind" in report["loaded"] or "decoder" in report["loaded"]):
            ve._text_feats = ve._ref_bank = None  # computed with the old weights
        expect = [r for k, roots in _COVERED_ROOTS.items() if weights.get(k) for r in roots]
        report["missing"] = [p for p in paths
                             if any(p == r or p.startswith(r + "/") for r in expect)
                             and p not in loaded_paths]
        for p in report["missing"][:20]:
            logging.warning("pretrained weights missing frozen leaf: %s", p)
        logging.info("load_pretrained_weights: %d leaves loaded across %d towers, %d missing",
                     sum(len(v) for v in report["loaded"].values()), len(report["loaded"]),
                     len(report["missing"]))
        return report

    @classmethod
    def from_config(cls, cfg: Mapping, *, device="cuda", policy: Optional[Policy] = None,
                    class_names: Optional[Sequence[str]] = None,
                    training: bool = False) -> "Myriad":
        """Build from the JAX package's config keys, read as ``Myriad.from_config``
        there reads them: arch_preset, image_size, num_query_token (full
        preset only), llm_vocab_size, llm_weight_dtype (int8 when unset and
        low_resource), llm_kv_dtype or its alias kv_cache_dtype, use_lora
        (the q/v LoRA pair), vit_weight_dtype, qformer_weight_dtype and
        ve_weight_dtype ("int8" quantizes the tower), llm_prefill_chunks,
        llm_staged_decode, llm_cache_granularity, llm_spec_k, end_sym,
        bos_at_generate, and param_policy or vit_precision (``policy`` wins
        when given; with none of the three the port serves bf16 storage,
        ``Policy.bf16_params``), the vision expert's keys: use_ve,
        init_vision_expert, clip_bpe_path, vis_expert, vis_expert_args,
        k_shot and round_index, and the keys that change training:
        freeze_vit, freeze_qformer, freeze_llama, train_llm_head,
        train_add_bos, use_grad_checkpoint and max_txt_len.
        The reference's dead knobs (noise_level, ...) and ``prompt_path`` (a
        prompt list no step reads) are accepted and inactive.

        The model comes back uninitialised: ``init_random`` or
        ``load_state_dicts`` fills it, and each then loads what the JAX
        from_config loads after its seeded initialisation: ``weights``
        (``{vit, qformer, llama, llama_proj, imagebind, decoder}``, npz
        paths; ``load_pretrained_weights``, report in ``weights_report``),
        with a ``q_former_model`` that names a local file folded into
        ``weights.qformer``, then ``ckpt`` (an npz tree, an Orbax checkpoint
        directory, a runner ring's unwrapped, or an earlier ``.pth`` of the
        port's ``CheckpointManager``) merged into the trainables.  The LLaMA
        tokenizer is ``llama_model``'s ``tokenizer.model`` where it names one
        (``tokenization.load_llama_tokenizer``), else ``ByteTokenizer``.  A
        ``ckpt`` the port cannot serve (a directory without ``_METADATA``, a
        .pth the port did not write) raises ``NotImplementedError``."""
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
        for key in ("vit_weight_dtype", "qformer_weight_dtype"):
            if cfg.get(key):
                arch = dataclasses.replace(arch, **{key: cfg[key]})
        if cfg.get("ve_weight_dtype"):
            arch = dataclasses.replace(arch, imagebind=dataclasses.replace(
                arch.imagebind, weight_dtype=cfg["ve_weight_dtype"]))
        model = cls(dataclasses.replace(arch, llama=llama),
                    policy=policy or policy_from_config(cfg), device=device,
                    llama_model=str(cfg.get("llama_model") or ""),
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
                    train_add_bos=cfg.get("train_add_bos", True), training=training,
                    use_ve=cfg.get("use_ve", True),
                    init_vision_expert=cfg.get("init_vision_expert", True),
                    clip_bpe_path=cfg.get("clip_bpe_path", ""),
                    vis_expert=cfg.get("vis_expert", "adrefexpert"),
                    vis_expert_args=(dict(cfg.get("vis_expert_args"))
                                     if cfg.get("vis_expert_args") else None),
                    k_shot=cfg.get("k_shot", 0), round_index=cfg.get("round_index", 0))
        weights = dict(cfg.get("weights") or {})
        q_former_model = str(cfg.get("q_former_model") or "")
        if q_former_model and "qformer" not in weights:
            if os.path.isfile(q_former_model):
                weights["qformer"] = q_former_model
            else:
                logging.warning("q_former_model '%s' is not a local file: convert it and "
                                "point weights.qformer at the npz", q_former_model)
        model._check_ve_weights(weights)
        model.weights = weights
        model.ckpt_path = str(cfg.get("ckpt") or "")
        return model

    # -- weights --------------------------------------------------------------
    def load_state_dicts(self, model_sd: Mapping[str, torch.Tensor],
                         ve_sd: Mapping[str, torch.Tensor]) -> None:
        """Load with strict=True: every leaf accounted for in both directions.
        A model without the vision expert takes no ``ve_sd`` (None or empty).
        Then the configured towers and checkpoint load over it."""
        self.module.load_state_dict(model_sd, strict=True)
        if self.vision_expert is None:
            if ve_sd:
                raise ValueError("vision-expert weights given, but the model has no vision "
                                 "expert (use_ve or init_vision_expert is False)")
        else:
            self.vision_expert.module.load_state_dict(ve_sd, strict=True)
            self.vision_expert._text_feats = self.vision_expert._ref_bank = None
        self._load_configured()

    def init_random(self, seed: int) -> None:
        """Seeded random weights, drawn on the model's device; then the
        configured towers and checkpoint load over them."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        init_random_(self.module, gen)
        if self.vision_expert is not None:
            init_random_(self.vision_expert.module, gen)
            self.vision_expert._text_feats = self.vision_expert._ref_bank = None
        self._load_configured()

    def _load_configured(self) -> None:
        """What from_config configured: the pretrained towers, then ``ckpt``."""
        if self.weights:
            self.weights_report = self.load_pretrained_weights(self.weights)
        if self.ckpt_path:
            self.load_checkpoint(self.ckpt_path)

    # -- host-side text plumbing ----------------------------------------------
    def split_prompt(self, question: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """'###Human: ' + q + ' ###Assistant: ' split at <ImageHere>, tokenised once."""
        prompt = "###Human: " + question + " ###Assistant: "
        if prompt not in self._prompt_cache:
            self._prompt_cache[prompt] = self.prompt_ids(*prompt.split("<ImageHere>"))
        return self._prompt_cache[prompt]

    # -- sample prep ----------------------------------------------------------
    def _image_question(self, samples: Dict, stage: int, training: bool):
        """(image on the device (uint8, or float32), the question of
        ``stage``, the scenes, the image paths); ``training`` appends the
        augmented twins (``aug_image``) with their scenes and paths."""
        image = samples["image"]
        image = (image if torch.is_tensor(image)
                 else torch.as_tensor(np.asarray(image))).to(self.device)
        if image.dtype != torch.uint8:
            image = image.float()
        scenes = list(samples["scene"])
        paths = list(samples.get("img_path", []))
        if training and "aug_image" in samples:
            aug = samples["aug_image"]
            aug = (aug if torch.is_tensor(aug) else torch.as_tensor(np.asarray(aug)))
            image = torch.cat([image, aug.to(device=self.device, dtype=image.dtype)])
            scenes, paths = scenes + scenes, paths + paths
        q_key = {0: "question", 1: "question2", 2: "question3"}[stage]
        questions = samples.get(q_key) or samples.get("question")
        question = questions[0] if isinstance(questions, (list, tuple)) else questions
        return image, question, scenes, paths

    def _expert_maps(self, image: torch.Tensor, scenes: List[str], paths: List[str],
                     one_shot: bool) -> torch.Tensor:
        """The maps of the model's expert: a precomputed-mask expert's by image
        path; the ImageBind expert's zero-shot maps, or its one-shot maps when
        ``one_shot`` and a reference bank is built; a muxed expert's one map
        type; zeros without an expert."""
        expert = self.expert
        if expert is None:
            return torch.zeros((image.shape[0], self.arch.map_size, self.arch.map_size, 1),
                               dtype=torch.float32, device=self.device)
        if isinstance(expert, PrecomputedMaskExpert):
            return expert(paths, scenes)[0]
        if expert is self.vision_expert:
            one_shot = one_shot and expert._ref_bank is not None
            return expert(image, scenes, one_shot=one_shot)[0]
        return expert(image, scenes)[0]

    def prepare_sample(self, samples: Dict, stage: int, training: bool = False):
        """(image, question, texts, maps, one_maps) for a batch, as the JAX
        package's ``prepare_sample`` gives them: ``maps`` the expert's
        (zero-shot for the ImageBind expert), ``one_maps`` its one-shot maps
        when a reference bank is built and ``maps`` otherwise.  ``training``
        appends the augmented twins and takes the target texts
        (``text_input`` then ``aug_text_input``)."""
        image, question, scenes, paths = self._image_question(samples, stage, training)
        texts = None
        if training and "text_input" in samples:
            texts = list(samples["text_input"]) + list(samples.get("aug_text_input", []))
        maps = self._expert_maps(image, scenes, paths, one_shot=False)
        one_maps = maps
        ve = self.vision_expert
        if self.expert is ve and ve is not None and ve._ref_bank is not None:
            one_maps = self._expert_maps(image, scenes, paths, one_shot=True)
        if training:  # out of inference mode: the map encoders train on them
            same = one_maps is maps
            maps = maps.clone()
            one_maps = maps if same else one_maps.clone()
        return image, question, texts, maps, one_maps

    def serving_maps(self, samples: Dict, stage: int):
        """(image, question, maps) of a batch to serve: the maps that
        ``generate`` feeds (the one-shot maps when ``k_shot > 0`` and the
        bank is built, as the JAX generate takes ``one_maps``), computed
        once."""
        image, question, scenes, paths = self._image_question(samples, stage, False)
        return image, question, self._expert_maps(image, scenes, paths, self.k_shot > 0)

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

    def _decode_fn(self, gen_cfg: GenerationConfig, cache_dtype, lookup_ids,
                   generator: Optional[torch.Generator] = None):
        """``greedy_generate`` (top-p sampling from ``generator`` when
        ``do_sample``), or its speculative twin when spec_k > 0 and decoding
        is greedy: a function embeds -> (tokens, stats), stats being the
        acceptance counters ({} on the plain path)."""
        llama = self.module.llama
        if self.spec_k > 0 and not gen_cfg.do_sample:
            return lambda embeds: speculative_generate(
                llama, embeds, config=gen_cfg, spec_k=self.spec_k, lookup_ids=lookup_ids,
                cache_dtype=cache_dtype, return_stats=True)
        return lambda embeds: (greedy_generate(llama, embeds, config=gen_cfg,
                                               cache_dtype=cache_dtype,
                                               generator=generator), {})

    def generate(self, samples: Dict, **generate_kwargs) -> Dict:
        """Greedy (or speculative, ``spec_k > 0``) decode of the AQA answer
        for a batch of images, or top-p sampling (``do_sample``) from a
        ``torch.Generator`` on the model's device seeded with ``seed``
        (default 0); ``spec_stats`` joins the result on the speculative
        path."""
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
        generator = None
        if gen_cfg.do_sample:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(int(generate_kwargs.get("seed", 0)))
        return self._generate_fused(samples, 1, gen_cfg, generator)

    @torch.inference_mode()
    def _generate_fused(self, samples: Dict, stage: int, gen_cfg: GenerationConfig,
                        generator: Optional[torch.Generator] = None) -> Dict:
        """The expert's maps (``serving_maps``) + encode_img + prefill + decode."""
        image, question, maps = self.serving_maps(samples, stage)
        before, after = self.split_prompt(question)
        # served with no bos embedding, as the reference generates, unless
        # bos_at_generate
        embeds = self.module.prefill_embeds(image, maps, before, after, stage,
                                            add_bos=self.bos_at_generate)
        cache_dtype = serving_cache_dtype(self.arch.llama, self.policy.compute_dtype)
        lookup = self._spec_lookup_ids(after) if self.spec_k > 0 else None
        tokens, stats = self._decode_fn(gen_cfg, cache_dtype, lookup, generator)(embeds)
        out = {"token_ids": tokens, "ve_anomaly_maps": maps}
        if stats:
            out["spec_stats"] = stats
        return out
