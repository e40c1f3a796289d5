"""MiniGPT-4, the stage-1 and stage-2 baseline (counterpart of
``myriad_tpu/models/mini_gpt4.py``): Myriad's tower stack without the vision
expert and its adaptors.

    EVA-ViT-g -> ln_vision -> Q-Former (32 queries) -> llama_proj -> Vicuna-7B

``MiniGPT4Module`` holds the weights and the compute, its modules named as
the flax ones, so ``convert_from_jax.state_dict_from_jax`` of the JAX
model's parameters loads with ``strict=True``.  ``MiniGPT4`` is the host
class: the trainable split (``llama_proj``, plus whatever the ``freeze_*``
knobs release), the prompt list of ``prompt_path`` formatted by
``prompt_template`` (one drawn per batch from the step's generator), the
target tokenisation (``end_sym``, ``max_txt_len``), ``prepare_train_arrays``
and ``train_loss`` for the runner, the pretrained towers
(``load_pretrained_weights``), ``load_checkpoint`` and ``shard`` (the LLaMA
over a mesh's model group, as Myriad's).  It builds on the
card unless the caller passes another device.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from myriad_tpu_torch import checkpoint as ckpt_lib
from myriad_tpu_torch.convert_from_jax import jax_path_of
from myriad_tpu_torch.models.base import TrainableModel
from myriad_tpu_torch.models.eva_vit import EvaViT
from myriad_tpu_torch.models.layers import (Dense, LayerNormFp32, Policy, init_random_,
                                            new_param)
from myriad_tpu_torch.models.llama import LlamaForCausalLM, lm_nll
from myriad_tpu_torch.models.myriad import MyriadArch
from myriad_tpu_torch.models.qformer import QFormer
from myriad_tpu_torch.parallel.mesh import from_lead
from myriad_tpu_torch.tokenization import load_llama_tokenizer

# the frozen roots each tower covers (the missing-leaf accounting), as the
# JAX ``load_pretrained_weights`` lists them
_COVERED_ROOTS = {"vit": ["visual_encoder"], "qformer": ["qformer", "query_tokens", "ln_vision"],
                  "llama": ["llama"], "llama_proj": ["llama_proj"]}


class MiniGPT4Module(nn.Module):
    """The weights and the compute (no host state)."""

    def __init__(self, arch: MyriadArch, *, policy: Policy, device,
                 use_grad_checkpoint: bool = False):
        super().__init__()
        a = arch
        self.arch = arch
        kw = dict(policy=policy, device=device)
        self.visual_encoder = EvaViT(img_size=a.img_size, patch_size=a.vit_patch,
                                     embed_dim=a.vit_dim, depth=a.vit_depth,
                                     num_heads=a.vit_heads, mlp_ratio=a.vit_mlp_ratio,
                                     use_checkpoint=use_grad_checkpoint, **kw)
        self.ln_vision = LayerNormFp32(a.vit_dim, eps=1e-5, **kw)
        self.qformer = QFormer(hidden_size=a.qformer_hidden, encoder_dim=a.vit_dim,
                               num_layers=a.qformer_layers, num_heads=a.qformer_heads,
                               intermediate_size=a.qformer_intermediate, **kw)
        self.query_tokens = new_param((1, a.num_query_token, a.qformer_hidden),
                                      policy.param_dtype, device)
        self.llama_proj = Dense(a.qformer_hidden, a.llama.hidden_size, **kw)
        self.llama = LlamaForCausalLM(a.llama, **kw)

    def encode_img(self, image: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) normalised images -> (B, num_query_token, LLaMA width)."""
        b = image.shape[0]
        feats = self.ln_vision(self.visual_encoder(image))
        q = self.query_tokens.to(feats.dtype).expand(b, -1, -1)
        return self.llama_proj(self.qformer(q, feats))

    def forward_train(self, image: torch.Tensor, before_ids: torch.Tensor,
                      after_ids: torch.Tensor, text_ids: torch.Tensor, text_mask: torch.Tensor,
                      bos_id: int = 1, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """[bos][before][image][after][text] through the LLaMA without a cache;
        the parts of the fp32 cross entropy of the text (``lm_nll``: the nll
        sum and the token count), the prefix and the padding masked out
        (-100).  With a sharded ``mesh`` the group's first rank runs the
        towers and broadcasts the image tokens; every rank computes the same
        loss."""
        b = image.shape[0]
        embed = self.llama.embed
        img = from_lead(mesh, lambda: self.encode_img(image),
                        (b, self.arch.num_query_token, self.arch.llama.hidden_size),
                        self.llama_proj.dtype, image.device)
        bos = embed(torch.full((b, 1), bos_id, dtype=torch.int64, device=img.device))
        before = embed(before_ids[None].expand(b, -1))
        after = embed(after_ids[None].expand(b, -1))
        prefix = torch.cat([bos, before, img.to(bos.dtype), after], dim=1)
        p = prefix.shape[1]
        inputs = torch.cat([prefix, embed(text_ids).to(prefix.dtype)], dim=1)
        mask = torch.cat([torch.ones((b, p), dtype=torch.int32, device=img.device),
                          text_mask.to(torch.int32)], dim=1)
        ignore = torch.full((b, p), -100, dtype=torch.int64, device=img.device)
        text_targets = torch.where(text_mask.bool(), text_ids.long(),
                                   torch.full_like(text_ids.long(), -100))
        logits = self.llama(inputs, None, attention_mask=mask)
        return lm_nll(logits, torch.cat([ignore, text_targets], dim=1))


class MiniGPT4(TrainableModel):
    """Host class: the module, the trainable split, the prompts and the step's
    tensors.  ``policy`` defaults to ``Policy.bf16`` (fp32 trainables, bf16
    compute and frozen storage), the JAX class's default."""

    def __init__(self, arch: Optional[MyriadArch] = None, *, policy: Optional[Policy] = None,
                 device="cuda", freeze_vit: bool = True, freeze_qformer: bool = True,
                 freeze_llama: bool = True, use_grad_checkpoint: bool = False,
                 llama_model: str = "", prompt_path: str = "", prompt_template: str = "",
                 max_txt_len: int = 32, end_sym: str = "\n", training: bool = False):
        self.arch = arch or MyriadArch.full()
        self.freeze_vit, self.freeze_qformer = bool(freeze_vit), bool(freeze_qformer)
        self.freeze_llama = bool(freeze_llama)
        self.max_txt_len = int(max_txt_len)
        self.end_sym = end_sym
        self.policy = policy or Policy.bf16()
        self.device = torch.device(device)
        self.training = bool(training)
        build = Policy(self.policy.compute_dtype, self.policy.compute_dtype)
        self.module = MiniGPT4Module(self.arch, policy=build, device=self.device,
                                     use_grad_checkpoint=use_grad_checkpoint)
        self.llama_tokenizer = load_llama_tokenizer(llama_model)
        self.prompt_list: List[str] = []
        if prompt_path:
            with open(prompt_path) as f:
                raw = f.read().splitlines()
            self.prompt_list = [prompt_template.format(p) for p in raw if "<ImageHere>" in p]
            logging.info("Loaded %d training prompts", len(self.prompt_list))
        self.weights: Dict = {}
        self.weights_report: Optional[Dict] = None
        self.ckpt_path = ""
        self.trainable_names: List[str] = self._split_trainable()
        self._prompt_cache: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def trainable_predicate(self) -> Callable[[str], bool]:
        """The JAX ``_trainable_predicate``: ``llama_proj``, and the Q-Former
        and its queries, EVA, or the LLaMA when their ``freeze_*`` is off."""

        def pred(name: str) -> bool:
            if name.startswith("llama_proj"):
                return True
            if not self.freeze_qformer and (name.startswith("qformer")
                                            or name == "query_tokens"):
                return True
            if not self.freeze_vit and name.startswith("visual_encoder"):
                return True
            return (not self.freeze_llama and name.startswith("llama")
                    and not name.startswith("llama_proj"))

        return pred

    # -- weights --------------------------------------------------------------
    def init_random(self, seed: int) -> None:
        """Seeded random weights, drawn on the model's device; then the
        configured towers and checkpoint load over them."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        init_random_(self.module, gen)
        self._load_configured()

    def load_state_dicts(self, model_sd: Mapping[str, torch.Tensor]) -> None:
        """Load with strict=True, then the configured towers and checkpoint."""
        self.module.load_state_dict(model_sd, strict=True)
        self._load_configured()

    def _load_configured(self) -> None:
        if self.weights:
            self.weights_report = self.load_pretrained_weights(self.weights)
        if self.ckpt_path:
            self.load_checkpoint(self.ckpt_path)

    @torch.no_grad()
    def load_pretrained_weights(self, weights: Mapping) -> Dict:
        """Merge converted towers (npz paths, Orbax directories or loaded
        trees in the JAX layout), as the JAX ``load_pretrained_weights``:
        ``vit`` under ``visual_encoder``, ``qformer`` (a tower-local tree is
        rooted under ``qformer``, its ``query_tokens`` and ``ln_vision``
        beside it) and ``llama`` under ``llama`` into the frozen parameters,
        ``llama_proj`` into the trainables.  Returns the report: ``loaded``
        and ``skipped`` paths by tower and ``missing``, the leaves under the
        given towers' roots that none supplied."""
        report: Dict = {"loaded": {}, "skipped": {}}
        trainable = set(self.trainable_names)
        state = self.module.state_dict()
        frozen = {n: t for n, t in state.items() if n not in trainable}
        loaded_paths = set()
        for key, root in (("vit", "visual_encoder"), ("qformer", ""), ("llama", "llama"),
                          ("llama_proj", "")):
            if not weights.get(key):
                continue
            tree = dict(ckpt_lib.load_params(weights[key]) if isinstance(weights[key], str)
                        else weights[key])
            if key == "qformer" and "qformer" not in tree:
                rooted = {"qformer": {k: v for k, v in tree.items()
                                      if k not in ("query_tokens", "ln_vision")}}
                rooted.update({k: tree[k] for k in ("query_tokens", "ln_vision") if k in tree})
                tree = rooted
            if root:
                tree = {root: tree}
            target = self.trainable_state_dict() if key == "llama_proj" else frozen
            loaded, skipped = ckpt_lib.merge_with_paths(target, tree)
            report["loaded"][key], report["skipped"][key] = loaded, skipped
            loaded_paths.update(loaded)
        expect = [r for k, roots in _COVERED_ROOTS.items() if weights.get(k) for r in roots]
        paths = [jax_path_of(self.module, n) for n in state]
        report["missing"] = [p for p in paths
                             if any(p == r or p.startswith(r + "/") for r in expect)
                             and p not in loaded_paths]
        if report["missing"]:
            logging.warning("pretrained weights: %d leaves NOT covered", len(report["missing"]))
        return report

    @classmethod
    def from_config(cls, cfg: Mapping, *, device="cuda", policy: Optional[Policy] = None,
                    training: bool = False) -> "MiniGPT4":
        """Build from the JAX package's keys, read as its ``from_config``
        reads them: arch_preset, image_size, freeze_vit, freeze_qformer,
        freeze_llama, use_grad_checkpoint, llama_model, prompt_path,
        prompt_template, max_txt_len, end_sym, and param_policy or
        vit_precision (``policy`` wins when given).  The model comes back
        uninitialised: ``init_random`` (from the section's ``seed``) or
        ``load_state_dicts`` fills it, and each then loads ``weights``
        (``{vit, qformer, llama, llama_proj}``; report in ``weights_report``)
        and ``ckpt`` (an npz tree, an Orbax directory, a runner ring's
        unwrapped, or an earlier ``.pth`` of the port's ``CheckpointManager``)
        into the trainables."""
        from myriad_tpu_torch.models.myriad import policy_from_config

        arch = MyriadArch.tiny() if cfg.get("arch_preset", "full") == "tiny" else MyriadArch.full()
        if cfg.get("image_size"):
            arch = dataclasses.replace(arch, img_size=int(cfg["image_size"]))
        model = cls(arch, policy=policy or policy_from_config(cfg) or Policy.bf16(),
                    device=device, freeze_vit=cfg.get("freeze_vit", True),
                    freeze_qformer=cfg.get("freeze_qformer", True),
                    freeze_llama=cfg.get("freeze_llama", True),
                    use_grad_checkpoint=cfg.get("use_grad_checkpoint", False),
                    llama_model=str(cfg.get("llama_model") or ""),
                    prompt_path=cfg.get("prompt_path", ""),
                    prompt_template=cfg.get("prompt_template", ""),
                    max_txt_len=cfg.get("max_txt_len", 32), end_sym=cfg.get("end_sym", "\n"),
                    training=training)
        model.weights = dict(cfg.get("weights") or {})
        model.ckpt_path = str(cfg.get("ckpt") or "")
        return model

    # -- the training step ---------------------------------------------------------
    def split_prompt(self, prompt: str) -> Tuple[torch.Tensor, torch.Tensor]:
        if prompt not in self._prompt_cache:
            self._prompt_cache[prompt] = self.prompt_ids(*prompt.split("<ImageHere>"))
        return self._prompt_cache[prompt]

    def prepare_train_arrays(self, samples: Dict, rng: np.random.Generator):
        """A batch's tensors: the image on the device, a prompt drawn from
        ``rng`` when there is a prompt list (else the bare image), its
        pieces' ids and the tokenised targets; no static stage."""
        image = samples["image"]
        image = (image if torch.is_tensor(image)
                 else torch.as_tensor(np.asarray(image, np.float32)))
        if self.prompt_list:
            prompt = self.prompt_list[int(rng.integers(0, len(self.prompt_list)))]
        else:
            prompt = "<ImageHere>"
        before, after = self.split_prompt(prompt)
        text_ids, text_mask = self.tokenize_targets(list(samples["text_input"]))
        arrays = {"image": image.to(self.device, torch.float32), "before": before,
                  "after": after, "text_ids": text_ids, "text_mask": text_mask}
        return arrays, ()

    def train_nll(self, arrays: Dict[str, torch.Tensor], static=()):
        """(nll sum, token count) of one batch; ``train_loss`` is their quotient."""
        return self.module.forward_train(arrays["image"], arrays["before"], arrays["after"],
                                         arrays["text_ids"], arrays["text_mask"], mesh=self.mesh)
