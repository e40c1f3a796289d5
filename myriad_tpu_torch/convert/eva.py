"""LAVIS EVA-ViT state dict -> the EVA-ViT parameter tree (the port's copy of
``myriad_tpu/convert/eva.py``; numpy only).  Conv kernels OIHW -> HWIO,
dense kernels (in, out)."""

from __future__ import annotations

from typing import Dict

from myriad_tpu_torch.convert.common import f32 as _t


def convert_eva_vit_state_dict(state_dict: Dict, depth: int = 39) -> Dict:
    sd = {k: _t(v) for k, v in state_dict.items()}

    def dense(name: str) -> Dict:
        return {"kernel": sd[name + ".weight"].T, "bias": sd[name + ".bias"]}

    def norm(name: str) -> Dict:
        return {"scale": sd[name + ".weight"], "bias": sd[name + ".bias"]}

    p: Dict = {
        "patch_embed": {"kernel": sd["patch_embed.proj.weight"].transpose(2, 3, 1, 0),
                        "bias": sd["patch_embed.proj.bias"]},
        "cls_token": sd["cls_token"],
        "pos_embed": sd["pos_embed"],
    }
    for i in range(depth):
        pre = f"blocks.{i}."
        p[f"blocks_{i}"] = {
            "norm1": norm(pre + "norm1"),
            "norm2": norm(pre + "norm2"),
            "attn": {"qkv": {"kernel": sd[pre + "attn.qkv.weight"].T},
                     "q_bias": sd[pre + "attn.q_bias"], "v_bias": sd[pre + "attn.v_bias"],
                     "proj": dense(pre + "attn.proj")},
            "mlp": {"fc1": dense(pre + "mlp.fc1"), "fc2": dense(pre + "mlp.fc2")},
        }
    return {"params": p}
