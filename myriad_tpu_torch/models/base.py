"""What the port's trainable models share (counterpart of
``myriad_tpu/models/base.py``): the trainable / frozen split by parameter
name, the trainables as named tensors, ``load_checkpoint`` and the target
tokenisation of the training step.

A subclass sets ``module`` (the ``nn.Module`` of weights), ``policy``,
``device``, ``training``, ``llama_tokenizer``, ``max_txt_len`` and
``end_sym``, defines ``trainable_predicate`` (its JAX twin's
``_trainable_predicate`` over the same module paths) and calls
``_split_trainable`` once its modules are built.  Under a policy with fp32
parameters and bf16 compute (``Policy.bf16``) the modules are built in the
compute dtype, and the trainables and the LayerNorm scales are raised to the
parameter dtype, as the JAX package's ``_cast_frozen`` leaves them.

``shard(mesh)`` makes the LLaMA (``module.llama``) this rank's
tensor-parallel shard, after the weights are loaded, for serving and for
training alike: the trainables keep their names (the JAX split's), a
sharded trainable (``lora_b``, ``lm_head`` under ``train_llm_head``) becomes
the rank's piece in its own dtype, and ``split_dims`` records the dim each
trainable is cut along (absent: whole).  The towers stay whole; under a mesh
only the model group's first rank runs them and broadcasts their output
(``parallel.mesh.Mesh.broadcast_from_lead``).
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from myriad_tpu_torch import checkpoint as ckpt_lib
from myriad_tpu_torch.models.layers import LayerNorm


class TrainableModel:
    module: nn.Module
    trainable_names: List[str]
    # the tensor-parallel mesh the LLaMA is sharded over (``shard``), and the
    # dim each sharded state entry is cut along, by name
    mesh = None
    split_dims: Dict[str, int] = {}

    def trainable_predicate(self) -> Callable[[str], bool]:  # pragma: no cover - overridden
        raise NotImplementedError

    def split_modules(self) -> List[Tuple[nn.Module, bool]]:
        """(module, whether its parameters may train) of every module whose
        parameters the split covers."""
        return [(self.module, True)]

    def _split_trainable(self) -> List[str]:
        """Give the trainables (and LayerNorm scales) the parameter dtype and,
        when training, ``requires_grad``; returns the trainable names."""
        pred = self.trainable_predicate()
        param_dtype = self.policy.param_dtype
        mods = self.split_modules()
        scales = {id(m.weight) for mod, _ in mods for m in mod.modules()
                  if isinstance(m, LayerNorm)}
        names = []
        for mod, may_train in mods:
            for name, p in mod.named_parameters():
                train = may_train and pred(name)
                if (train or id(p) in scales) and p.dtype != param_dtype:
                    p.data = p.data.to(param_dtype)
                p.requires_grad_(train and self.training)
                if train:
                    names.append(name)
        return names

    def shard(self, mesh) -> "TrainableModel":
        """Make the LLaMA ``mesh``'s model-group shard of this rank
        (``LlamaForCausalLM.sharded``, ``LLAMA_RULES``) once its weights are
        loaded; the trainable split is applied again to the new modules.  A
        mesh of one changes nothing.  Returns the model."""
        if mesh.sharded:
            if self.mesh is not None:
                raise ValueError("the model is already sharded")
            llama = self.module.llama.sharded(mesh)
            self.module.llama = llama
            self.mesh = mesh
            self.trainable_names = self._split_trainable()
            self.split_dims = {f"llama.{n}": d for n, d in llama.split_dims.items()
                               if d is not None and f"llama.{n}" in self.trainable_names}
        return self

    def train_nll(self, arrays: Dict[str, torch.Tensor], static=()):  # pragma: no cover
        raise NotImplementedError

    def train_loss(self, arrays: Dict[str, torch.Tensor], static=()) -> torch.Tensor:
        """The loss of one batch: ``train_nll``'s sum over its token count (at
        least 1), the mean over the batch's target tokens."""
        total, count = self.train_nll(arrays, static)
        return total / count.clamp_min(1)

    def trainable_state_dict(self) -> Dict[str, torch.Tensor]:
        params = dict(self.module.named_parameters())
        return {n: params[n] for n in self.trainable_names}

    def trainable_parameters(self) -> List[Tuple[str, nn.Parameter]]:
        params = dict(self.module.named_parameters())
        return [(n, params[n]) for n in self.trainable_names]

    @torch.no_grad()
    def load_checkpoint(self, path: str) -> Tuple[List[str], List[str]]:
        """Merge a checkpoint into the trainables, as the JAX
        ``load_checkpoint`` merges (strict=False: unknown leaves ignored,
        missing ones kept): an Orbax directory or an npz tree in the JAX
        layout by path (a runner ring's ``model`` unwrapped), or an earlier
        ``.pth`` file of the port's ``CheckpointManager`` by name.  Returns
        (loaded, skipped)."""
        if path.endswith(".npz") or os.path.isdir(path):
            tree = ckpt_lib.unwrap_ring(ckpt_lib.load_params(path))
            loaded, skipped = ckpt_lib.merge_with_paths(self.trainable_state_dict(), tree)
        else:
            state = ckpt_lib.load_checkpoint(path)
            loaded, skipped = ckpt_lib.merge_into(self.trainable_state_dict(), state["model"])
        if not loaded:
            logging.warning("load checkpoint from %s matched no trainable parameter", path)
        logging.info("load checkpoint from %s (%d loaded, %d unknown)", path, len(loaded),
                     len(skipped))
        return loaded, skipped

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

    def prompt_ids(self, before: str, after: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """The two pieces of a prompt around ``<ImageHere>``, tokenised
        without special tokens, as int64 tensors on the model's device."""
        ids = []
        for piece in (before, after):
            tok = self.llama_tokenizer(piece, add_special_tokens=False)["input_ids"]
            tok = tok[0] if tok and isinstance(tok[0], list) else tok
            ids.append(torch.tensor(tok, dtype=torch.int64, device=self.device))
        return ids[0], ids[1]
