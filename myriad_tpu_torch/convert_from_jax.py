"""Weights bridge: the JAX package's parameter trees -> the port's state dicts.

``state_dict_from_jax`` takes a nested dict of arrays (``Myriad.params``,
``MiniGPT4.params`` or ``VisionExpert.params["params"]`` from
``myriad_tpu``, or a SimpleNet embedder's or head's tree, leaves as anything
``np.asarray`` reads) and returns the state dict that the port's
``MyriadModule``, ``MiniGPT4Module``, ``AnomalyExpertModule``,
``SimpleNetEmbedder`` or ``SimpleHead`` loads with ``strict=True``.
The port's modules mirror the JAX package's module names, so the bridge only:

* turns list entries ``blocks_3`` / ``layers_3`` / ``layer_3`` / ``conv_3`` /
  ``fc_3`` into ``nn.ModuleList`` keys ``blocks.3``;
* transposes Dense kernels (in, out) into torch's (out, in) ``weight``, and
  conv kernels (kh, kw, in, out) into (out, in, kh, kw);
* renames LayerNorm's and ``BatchNormInference``'s ``scale`` to ``weight``
  (an int8 layer's ``scale``, beside its ``w_int8``, stays: int8 weights
  keep the (in, out) layout); BatchNorm's ``bias``, ``mean`` and ``var``
  keep their names.

An int4 layer's ``w_int4`` (in/2, out) and ``scale4`` (in/group, out) pass
through as they are: neither is a ``kernel`` nor a ``scale``, and kernel B5
reads the JAX package's layout.

``jax_leaves`` gives each leaf's '/'-joined path in the JAX tree beside its
state-dict name (the weights loaders account by those paths, as the JAX
package does); ``jax_path_of`` goes the other way for a module's state-dict
name, ``tree_of`` writes named tensors into the JAX layout (dtypes kept: an
Orbax checkpoint's trainables and optimizer moments), and
``tree_from_module`` a module's parameters (numpy, fp32 for any float), the
tree that ``save_params`` stores.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_LIST_ENTRY = re.compile(r"^(blocks|layers|layer|conv|fc)_(\d+)$")


def _to_tensor(x) -> torch.Tensor:
    if torch.is_tensor(x):  # an Orbax directory's leaves (bfloat16 among them)
        return x.detach().cpu()
    a = np.asarray(x)
    # np.ascontiguousarray makes a 0-d array 1-d: reshape keeps a scalar a scalar
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(
            torch.bfloat16).reshape(a.shape)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).reshape(a.shape)


def jax_leaves(tree: Mapping) -> List[Tuple[str, str, torch.Tensor]]:
    """(JAX path 'a/b/c', state-dict name, tensor in the port's layout) for
    every leaf of ``tree``, in the tree's order."""
    out: List[Tuple[str, str, torch.Tensor]] = []

    def rec(node: Mapping, path: str, prefix: str) -> None:
        for name, leaf in node.items():
            p = f"{path}/{name}" if path else str(name)
            if isinstance(leaf, Mapping):
                m = _LIST_ENTRY.match(name)
                rec(leaf, p, prefix + (f"{m.group(1)}.{m.group(2)}" if m else name) + ".")
                continue
            t = _to_tensor(leaf)
            if name == "kernel" and t.dim() == 2:
                name, t = "weight", t.t().contiguous()
            elif name == "kernel" and t.dim() == 4:
                name, t = "weight", t.permute(3, 2, 0, 1).contiguous()
            elif name == "scale" and "w_int8" not in node:
                name = "weight"
            out.append((p, prefix + name, t))
    rec(tree, "", "")
    return out


def state_dict_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    return {name: t for _, name, t in jax_leaves(tree)}


_PORT_ENTRY = re.compile(r"^(blocks|layers|layer|conv|fc)$")


def jax_path_of(module: nn.Module, name: str) -> str:
    """The JAX path of ``module``'s state-dict entry ``name``: list entries
    ``blocks.3`` -> ``blocks_3``, a Dense or convolution ``weight`` ->
    ``kernel``, a LayerNorm's ``weight`` -> ``scale``."""
    from myriad_tpu_torch.models.layers import Conv2d, Dense, LayerNorm

    *mods, leaf = name.split(".")
    if leaf == "weight":
        owner = module.get_submodule(".".join(mods))
        if isinstance(owner, (Dense, Conv2d)):
            leaf = "kernel"
        elif isinstance(owner, LayerNorm):
            leaf = "scale"
    parts: List[str] = []
    for part in mods:
        if part.isdigit() and parts and _PORT_ENTRY.match(parts[-1]):
            parts[-1] = f"{parts[-1]}_{part}"
        else:
            parts.append(part)
    return "/".join(parts + [leaf])


def tree_of(module: nn.Module, tensors: Mapping[str, torch.Tensor]) -> Dict:
    """The JAX-layout tree of ``tensors``, entries of ``module``'s state dict
    by name (or tensors of their shapes, such as an optimizer's moments):
    each at its ``jax_path_of`` path, kernels in the JAX layout, as CPU
    tensors of their own dtype."""
    tree: Dict = {}
    for name, t in tensors.items():
        path = jax_path_of(module, name)
        t = t.detach().cpu()
        if path.endswith("/kernel") and t.dim() == 2:
            t = t.t()
        elif path.endswith("/kernel") and t.dim() == 4:
            t = t.permute(2, 3, 1, 0)
        node = tree
        *dirs, leaf = path.split("/")
        for d in dirs:
            node = node.setdefault(d, {})
        node[leaf] = t.contiguous()
    return tree


def tree_from_module(module: nn.Module) -> Dict:
    """``module``'s parameters and buffers as a JAX-layout tree of numpy
    arrays (floats in fp32)."""

    def numpy(node):
        if isinstance(node, dict):
            return {k: numpy(v) for k, v in node.items()}
        return (node.float() if node.is_floating_point() else node).numpy()

    return numpy(tree_of(module, module.state_dict()))
