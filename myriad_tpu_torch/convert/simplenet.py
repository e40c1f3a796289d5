"""SimpleNet torch checkpoints -> the SimpleNet trees (the port's copy of
``myriad_tpu/convert/simplenet.py``; numpy only).

The reference ships per-class SimpleNet heads as ``{root}/{class}/ckpt.pth``
with ``discriminator`` and ``pre_projection`` sub-state-dicts, over a
WideResNet-50-2 trunk (torchvision ``wide_resnet50_2`` names).
"""

from __future__ import annotations

from typing import Dict

from myriad_tpu_torch.convert.common import f32 as _t


def convert_simplenet_head_state_dict(ckpt: Dict, dsc_layers: int = 2,
                                      pre_proj: int = 1) -> Dict:
    """ckpt: {'discriminator': sd, 'pre_projection': sd} -> SimpleHead params."""
    p: Dict = {}
    if "pre_projection" in ckpt and pre_proj > 0:
        sd = ckpt["pre_projection"]
        p["pre_projection"] = {f"fc_{i}": {"kernel": _t(sd[f"layers.{i}fc.weight"]).T,
                                           "bias": _t(sd[f"layers.{i}fc.bias"])}
                               for i in range(pre_proj)}
    dsc_sd = ckpt["discriminator"]
    dsc: Dict = {}
    for i in range(dsc_layers - 1):
        pre = f"body.block{i + 1}."
        dsc[f"block{i + 1}_fc"] = {"kernel": _t(dsc_sd[pre + "0.weight"]).T,
                                   "bias": _t(dsc_sd[pre + "0.bias"])}
        dsc[f"block{i + 1}_bn"] = {"scale": _t(dsc_sd[pre + "1.weight"]),
                                   "bias": _t(dsc_sd[pre + "1.bias"]),
                                   "mean": _t(dsc_sd[pre + "1.running_mean"]),
                                   "var": _t(dsc_sd[pre + "1.running_var"])}
    dsc["tail"] = {"kernel": _t(dsc_sd["tail.weight"]).T}
    p["discriminator"] = dsc
    return {"params": p}


_STAGE_BLOCKS = {"layer1": 3, "layer2": 4, "layer3": 6}


def convert_wide_resnet50_state_dict(sd: Dict) -> Dict:
    """torchvision ``wide_resnet50_2`` state dict -> the WideResNet50 tree
    (layers 1-3 only: SimpleNet taps layer2 and layer3)."""
    sd = {k: _t(v) for k, v in sd.items()}

    def conv(key: str) -> Dict:
        return {"kernel": sd[key].transpose(2, 3, 1, 0)}

    def bn(prefix: str) -> Dict:
        return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"],
                "mean": sd[prefix + ".running_mean"], "var": sd[prefix + ".running_var"]}

    p: Dict = {"conv1": conv("conv1.weight"), "bn1": bn("bn1")}
    for stage, blocks in _STAGE_BLOCKS.items():
        for i in range(blocks):
            pre = f"{stage}.{i}."
            b: Dict = {}
            for j in (1, 2, 3):
                b[f"conv{j}"] = conv(pre + f"conv{j}.weight")
                b[f"bn{j}"] = bn(pre + f"bn{j}")
            if pre + "downsample.0.weight" in sd:
                b["downsample_conv"] = conv(pre + "downsample.0.weight")
                b["downsample_bn"] = bn(pre + "downsample.1")
            p[f"{stage}_{i}"] = b
    return {"params": p}
