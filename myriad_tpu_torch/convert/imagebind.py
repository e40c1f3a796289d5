"""ImageBind-huge state dict -> the vision and text tower trees, and the
AnomalyGPT ``LinearLayer`` decoder (the port's copy of
``myriad_tpu/convert/imagebind.py``; numpy only).

The video stem's Conv3d kernel (D, 3, 2, 14, 14) is summed over time: exact,
since the stem sees one frame repeated twice.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from myriad_tpu_torch.convert.common import f32 as _t
from myriad_tpu_torch.models.imagebind import ImageBindConfig


def _norm(sd: Dict, name: str) -> Dict:
    return {"scale": sd[name + ".weight"], "bias": sd[name + ".bias"]}


def _dense(sd: Dict, name: str) -> Dict:
    return {"kernel": sd[name + ".weight"].T, "bias": sd[name + ".bias"]}


def _block(sd: Dict, pre: str) -> Dict:
    return {
        "norm_1": _norm(sd, pre + "norm_1"),
        "norm_2": _norm(sd, pre + "norm_2"),
        "attn": {"in_proj": {"kernel": sd[pre + "attn.in_proj_weight"].T,
                             "bias": sd[pre + "attn.in_proj_bias"]},
                 "out_proj": _dense(sd, pre + "attn.out_proj")},
        "fc1": _dense(sd, pre + "mlp.fc1"),
        "fc2": _dense(sd, pre + "mlp.fc2"),
    }


def convert_imagebind_state_dict(state_dict: Dict, config: ImageBindConfig) -> Dict:
    sd = {k: _t(v) for k, v in state_dict.items()}
    stem = sd["modality_preprocessors.vision.rgbt_stem.proj.1.weight"]
    trunk: Dict = {"pre_ln": _norm(sd, "modality_trunks.vision.pre_transformer_layer.0")}
    for i in range(config.vision_num_blocks):
        trunk[f"blocks_{i}"] = _block(sd, f"modality_trunks.vision.blocks.{i}.")
    visual = {
        # (D, 3, T, 14, 14) -> sum over T -> HWIO (14, 14, 3, D)
        "rgbt_stem": {"kernel": stem.sum(axis=2).transpose(2, 3, 1, 0)},
        "cls_token": sd["modality_preprocessors.vision.cls_token"].reshape(1, 1, -1),
        "pos_embed": sd["modality_preprocessors.vision.pos_embedding_helper.pos_embed"],
        "trunk": trunk,
        "head_ln": _norm(sd, "modality_heads.vision.0"),
        "head_proj": {"kernel": sd["modality_heads.vision.2.weight"].T},
    }
    scale = sd.get("modality_postprocessors.text.1.log_logit_scale")
    text = {
        "token_embedding": {
            "embedding": sd["modality_preprocessors.text.token_embedding.weight"]},
        "pos_embed": sd["modality_preprocessors.text.pos_embed"],
        "trunk": {f"blocks_{i}": _block(sd, f"modality_trunks.text.blocks.{i}.")
                  for i in range(config.text_num_blocks)},
        "head_ln": _norm(sd, "modality_heads.text.proj.0"),
        "head_proj": {"kernel": sd["modality_heads.text.proj.1.weight"].T},
        "log_logit_scale": (np.float32(scale.reshape(())) if scale is not None
                            else np.float32(np.log(1 / 0.07))),
    }
    return {"params": {"visual": visual, "text": text}}


def convert_anomaly_decoder_state_dict(state_dict: Dict, num_taps: int = 4) -> Dict:
    """AnomalyGPT ``image_decoder.fc.{i}.{weight,bias}`` (or bare ``fc.{i}``)
    -> the ``LinearLayerDecoder`` tree."""
    sd = {k: _t(v) for k, v in state_dict.items()}
    p: Dict = {}
    for i in range(num_taps):
        pre = next((c for c in (f"image_decoder.fc.{i}.", f"fc.{i}.") if c + "weight" in sd),
                   None)
        if pre is None:
            raise KeyError(f"decoder weights for tap {i} not found")
        p[f"fc_{i}"] = _dense(sd, pre.rstrip("."))
    return {"params": p}
