"""Myriad trainable-net checkpoint -> the ``MyriadModule`` tree (the port's
copy of ``myriad_tpu/convert/networks.py``; numpy only).

The reference's epoch checkpoints (``checkpoint_N.pth``) store only the
trainable modules: ``expert_adaptor`` (LoraAdaptorV2), ``VEInstructor``
(VEInstructorV2), ``VETokenizer`` and, with use_lora, the peft LLaMA LoRA
leaves.  ``llama_proj`` travels in the MiniGPT-4 base checkpoint under the
same flat key convention.  Layouts: an nn.Linear weight (out, in) -> kernel
(in, out); an nn.Conv2d weight OIHW -> HWIO; the ``meta_net`` Sequential
holds its convs at 0, 3, 6, 9, 12 (each followed by ReLU and MaxPool) and
the head conv at 15 (version 0 instructor and tokenizer); peft
``...layers.N.self_attn.{q,v}_proj.lora_{A,B}.weight`` under any prefix ->
``llama/model/layers_N/self_attn/*/lora_{a,b}/kernel``.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np

from myriad_tpu_torch.convert.common import f32 as _t


def _conv(w) -> np.ndarray:
    return _t(w).transpose(2, 3, 1, 0)  # OIHW -> HWIO


_PYRAMID_IDX = (0, 3, 6, 9, 12)
_HEAD_IDX = 15


def _pyramid_net(sd: Dict, prefix: str) -> Dict:
    """meta_net Sequential -> {pyramid: {conv_i}, head}."""
    def conv(idx: int) -> Dict:
        return {"kernel": _conv(sd[f"{prefix}meta_net.{idx}.weight"]),
                "bias": _t(sd[f"{prefix}meta_net.{idx}.bias"])}

    return {"pyramid": {f"conv_{i}": conv(idx) for i, idx in enumerate(_PYRAMID_IDX)},
            "head": conv(_HEAD_IDX)}


_LORA_RE = re.compile(
    r"layers\.(\d+)\.self_attn\.(q_proj|v_proj)\.lora_([AB])\.(?:default\.)?weight$")


def convert_myriad_trainables_state_dict(state_dict: Dict) -> Dict:
    """Flat torch state dict (the reference's trainable checkpoint or the
    MiniGPT-4 base checkpoint) -> {"params": ...} rooted at the
    ``MyriadModule`` tree.  Only keys that are present convert; the result
    merges strict=False into the model."""
    sd = dict(state_dict)
    p: Dict = {}
    if "expert_adaptor.conv1.weight" in sd:
        p["expert_adaptor"] = {"conv1": {"kernel": _t(sd["expert_adaptor.conv1.weight"]).T},
                               "conv2": {"kernel": _t(sd["expert_adaptor.conv2.weight"]).T}}
    if "VEInstructor.meta_net.0.weight" in sd:
        if f"VEInstructor.meta_net.{_HEAD_IDX}.weight" not in sd:
            raise ValueError("only VEInstructorV2 version 0 (49 tokens, head at Sequential "
                             "index 15) is convertible; versions 1/2 add mid convs")
        p["ve_instructor"] = _pyramid_net(sd, "VEInstructor.")
    if "VETokenizer.meta_net.0.weight" in sd:
        p["ve_tokenizer"] = _pyramid_net(sd, "VETokenizer.")
        p["ve_tokenizer"]["base_prompts"] = _t(sd["VETokenizer.base_prompts"])
    if "llama_proj.weight" in sd:
        p["llama_proj"] = {"kernel": _t(sd["llama_proj.weight"]).T}
        if "llama_proj.bias" in sd:
            p["llama_proj"]["bias"] = _t(sd["llama_proj.bias"])
    if "query_tokens" in sd:
        p["query_tokens"] = _t(sd["query_tokens"])
    # peft LoRA leaves, under any wrapper prefix (llama_model.base_model.model...)
    for key, val in sd.items():
        m = _LORA_RE.search(key)
        if not m:
            continue
        layer, proj, ab = int(m.group(1)), m.group(2), m.group(3).lower()
        dst = (p.setdefault("llama", {}).setdefault("model", {})
               .setdefault(f"layers_{layer}", {}).setdefault("self_attn", {})
               .setdefault(proj, {}))
        dst[f"lora_{ab}"] = {"kernel": _t(val).T}
    return {"params": p}
