"""Weights bridge: the JAX package's parameter trees -> the port's state dicts.

``state_dict_from_jax`` takes a nested dict of arrays (``Myriad.params`` or
``VisionExpert.params["params"]`` from ``myriad_tpu``, leaves as anything
``np.asarray`` reads) and returns the state dict that the port's
``MyriadModule`` or ``AnomalyExpertModule`` loads with ``strict=True``.
The port's modules mirror the JAX package's module names, so the bridge only:

* turns list entries ``blocks_3`` / ``layers_3`` / ``layer_3`` / ``conv_3`` /
  ``fc_3`` into ``nn.ModuleList`` keys ``blocks.3``;
* transposes Dense kernels (in, out) into torch's (out, in) ``weight``, and
  conv kernels (kh, kw, in, out) into (out, in, kh, kw);
* renames LayerNorm ``scale`` to ``weight`` (an int8 layer's ``scale``, beside
  its ``w_int8``, stays: int8 weights keep the (in, out) layout).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_LIST_ENTRY = re.compile(r"^(blocks|layers|layer|conv|fc)_(\d+)$")


def _to_tensor(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def state_dict_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}

    def rec(node: Mapping, prefix: str) -> None:
        for name, leaf in node.items():
            if isinstance(leaf, Mapping):
                m = _LIST_ENTRY.match(name)
                rec(leaf, prefix + (f"{m.group(1)}.{m.group(2)}" if m else name) + ".")
                continue
            t = _to_tensor(leaf)
            if name == "kernel" and t.dim() == 2:
                name, t = "weight", t.t().contiguous()
            elif name == "kernel" and t.dim() == 4:
                name, t = "weight", t.permute(3, 2, 0, 1).contiguous()
            elif name == "scale" and "w_int8" not in node:
                name = "weight"
            out[prefix + name] = t
    rec(tree, "")
    return out
