"""Training checkpoints (counterpart of ``myriad_tpu/checkpoint.py``'s ring and
merge).

``CheckpointManager`` keeps the JAX package's ring rule: a save with an
integer tag (or a string of digits) joins the ring, and past
``max_checkpoints`` the oldest is deleted; other tags ("best") stay.  Each
save is an Orbax checkpoint directory, ``checkpoint_{tag}``, in the layout
the JAX package restores and resumes (``orbax_format.checkpointer.save``);
``restore(tag)`` reads one back.  Across ranks every rank calls ``save``:
rank 0 clears the directory, writes it and deletes the ring's oldest, with
barriers between, as the JAX manager's primary host does.  ``load_checkpoint`` and
``is_port_checkpoint`` still read the ``checkpoint_{tag}.pth`` files the port
wrote before (trainables by name, the optimizer's state, ``epoch``,
``global_step`` and a ``format`` marker).  ``merge_into`` copies a
saved state into live parameters by name with the JAX ``merge_trees`` rule
(strict=False: unknown names and shape mismatches skipped, missing ones
kept, values cast to the parameter's dtype).  ``load_params`` reads a
parameter tree that the JAX package's ``save_params`` wrote (``.npz``, flat
``/``-joined keys), a torch ``.pth`` state dict (a flat dict, unwrapped
from a ``model`` entry, as the JAX ``load_params`` reads the reference's
checkpoints) or an Orbax checkpoint directory (its whole tree, leaves as
CPU tensors, the port's own reader).  ``save_params`` writes the npz
layout.  ``merge_with_paths`` merges such a tree into a module's tensors
by the same rule, through the weights bridge (``convert_from_jax``), and
accounts by the tree's paths, as the JAX one does.  ``unwrap_ring`` takes
the trainables out of a runner's ring checkpoint.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from myriad_tpu_torch.common import dist
from myriad_tpu_torch.orbax_format import checkpointer

FORMAT = "myriad_tpu_torch.checkpoint/1"


@torch.no_grad()
def merge_into(params: Mapping[str, torch.Tensor],
               incoming: Mapping[str, torch.Tensor]) -> Tuple[List[str], List[str]]:
    """Copy ``incoming`` into ``params`` where a name and shape match; returns
    (loaded, skipped) names."""
    loaded, skipped = [], []
    for name, value in incoming.items():
        target = params.get(name)
        if target is None:
            skipped.append(name)
        elif tuple(target.shape) != tuple(value.shape):
            logging.warning("shape mismatch at %s: %s vs %s; skipped", name,
                            tuple(target.shape), tuple(value.shape))
            skipped.append(name)
        else:
            target.copy_(value.to(device=target.device, dtype=target.dtype))
            loaded.append(name)
    return loaded, skipped


def unflatten_dict(flat: Mapping[str, Any]) -> Dict:
    """{'a/b/c': leaf} -> {'a': {'b': {'c': leaf}}}."""
    out: Dict = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def save_params(path: str, tree: Mapping) -> str:
    """Write a parameter tree as ``.npz`` with flat '/'-joined keys, the JAX
    package's ``save_params`` layout; returns the path written."""
    flat: Dict[str, np.ndarray] = {}

    def rec(node: Mapping, prefix: str) -> None:
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                rec(v, key)
            else:
                flat[key] = np.asarray(v)

    rec(tree, "")
    path = path if path.endswith(".npz") else path + ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)
    return path


def load_params(path: str) -> Dict:
    """A parameter tree from an ``.npz`` file in the JAX package's
    ``save_params`` layout (nested dicts of numpy arrays), the flat dict of
    a torch ``.pth``/``.pt``/``.bin`` file (its ``model`` entry when it has
    one), each tensor as fp32 numpy, read with ``weights_only=True``, or the
    tree of an Orbax checkpoint directory, as the JAX ``load_params`` gives
    ``ocp.StandardCheckpointer().restore`` (leaves as CPU tensors)."""
    if os.path.isdir(path):
        return checkpointer.restore(path)
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as f:
            return unflatten_dict({k: f[k] for k in f.files})
    if path.endswith((".pth", ".pt", ".bin")):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(ckpt, dict) and "model" in ckpt:
            ckpt = ckpt["model"]
        return {k: np.asarray(v.float().numpy() if hasattr(v, "float") else v)
                for k, v in ckpt.items()}
    raise ValueError(f"Unsupported checkpoint format: {path}")


# safetensors dtype names -> torch dtypes (the dtypes a checkpoint holds)
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a ``.safetensors`` file by name, on the CPU, without
    the ``safetensors`` package: an 8-byte little-endian header length, a
    JSON header of ``{name: {dtype, shape, data_offsets}}`` (offsets from
    the end of the header), then the little-endian bytes.  The tensors
    share one buffer holding the file."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = bytearray(os.path.getsize(path) - 8 - n)
        if f.readinto(data) != len(data):
            raise ValueError(f"{path}: the file ended before its tensors' bytes")
    out: Dict[str, torch.Tensor] = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(spec["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {spec['dtype']}, which the reader "
                             f"does not take ({', '.join(SAFETENSORS_DTYPES)})")
        begin, end = spec["data_offsets"]
        shape = [int(d) for d in spec["shape"]]
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != itemsize * int(np.prod(shape)) or end > len(data):
            raise ValueError(f"{path}: {name}'s byte range {begin}..{end} does not hold "
                             f"{spec['dtype']} {shape}")
        if begin == end:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(data, dtype=dtype, count=(end - begin) // itemsize,
                                         offset=begin).reshape(shape)
    return out


def unwrap_ring(tree: Mapping) -> Mapping:
    """The trainables of a runner's ring checkpoint (``model`` beside
    ``optimizer`` or ``epoch``), else ``tree`` itself."""
    if isinstance(tree, Mapping) and "model" in tree and ("optimizer" in tree
                                                           or "epoch" in tree):
        return tree["model"]
    return tree


@torch.no_grad()
def merge_with_paths(params: Mapping[str, torch.Tensor], tree: Mapping,
                     prefix: str = "") -> Tuple[List[str], List[str]]:
    """The JAX package's ``merge_with_paths`` over live tensors: merge a
    JAX-layout tree into ``params`` (state-dict name -> tensor, copied in
    place) by ``merge_into``'s rule; returns (loaded, skipped) as the tree's
    '/'-joined paths, each under ``prefix`` when given.  As in the JAX walk,
    a subtree that ``params`` lacks is skipped as one path (its root), a
    leaf whose shape differs by its own path."""
    from myriad_tpu_torch.convert_from_jax import _LIST_ENTRY, jax_leaves

    incoming, path_of = {}, {}
    for path, name, value in jax_leaves(tree):
        incoming[name] = value
        path_of[name] = path
    loaded, skipped = merge_into(params, incoming)
    nodes = set()  # every state-dict name and name prefix of ``params``
    for name in params:
        parts = name.split(".")
        nodes.update(".".join(parts[:i]) for i in range(1, len(parts) + 1))
    out_skipped: List[str] = []
    for name in skipped:
        segs = path_of[name].split("/")
        node = len(segs)  # a shape mismatch: the leaf itself
        if name not in params:
            dotted = ""
            for i, seg in enumerate(segs[:-1]):
                m = _LIST_ENTRY.match(seg)
                dotted += ("." if dotted else "") + (f"{m.group(1)}.{m.group(2)}" if m else seg)
                if dotted not in nodes:
                    node = i + 1
                    break
        path = "/".join(segs[:node])
        if path not in out_skipped:
            out_skipped.append(path)
    join = (lambda p: f"{prefix}/{p}") if prefix else (lambda p: p)
    return [join(path_of[n]) for n in loaded], [join(p) for p in out_skipped]


def merge_params(module: nn.Module, tree: Mapping) -> Tuple[List[str], List[str]]:
    """Merge a JAX-layout parameter tree into ``module`` non-strictly: each
    leaf that names a parameter of the same shape is cast to its dtype and
    copied in; unknown leaves and shape mismatches are skipped with a
    warning; parameters the tree lacks keep their values.  Returns (loaded,
    skipped) paths."""
    loaded, skipped = merge_with_paths(module.state_dict(), tree)
    if skipped:
        logging.warning("merge_params: %d leaves skipped (unknown or mismatched), e.g. %s",
                        len(skipped), skipped[:3])
    return loaded, skipped


def load_checkpoint(path: str) -> Dict:
    state = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(state, dict) or state.get("format") != FORMAT:
        raise ValueError(f"{path} is not a checkpoint of myriad_tpu_torch's CheckpointManager")
    return state


def is_port_checkpoint(path: str) -> bool:
    """Whether ``path`` is a file that the port's ``CheckpointManager`` wrote."""
    if not os.path.isfile(path):
        return False
    try:
        load_checkpoint(path)
    except Exception:  # any other file: a pickle, an archive, an npz
        return False
    return True


class CheckpointManager:
    """Epoch checkpoints with ring retention (the JAX package's
    ``CheckpointManager`` rule, one Orbax directory a save)."""

    def __init__(self, output_dir: str, max_checkpoints: int = -1):
        self.output_dir = output_dir
        self.max_checkpoints = max_checkpoints
        self._saved: List[str] = []
        if dist.is_main_process():
            os.makedirs(output_dir, exist_ok=True)

    def path(self, tag) -> str:
        return os.path.join(self.output_dir, f"checkpoint_{tag}")

    def save(self, tag, state: Optional[Dict]) -> str:
        """Write ``state`` (nested dicts and lists of tensors, arrays and
        numbers) as the directory ``checkpoint_{tag}``; an integer tag joins
        the ring.  Every rank calls it (``state`` is read on rank 0 alone);
        no rank returns before the directory is whole."""
        main = dist.is_main_process()
        path = os.path.abspath(self.path(tag))
        if main and os.path.exists(path):
            shutil.rmtree(path)
        dist.barrier("ckpt_clear")
        if main:
            checkpointer.save(path, state)
        dist.barrier("ckpt_write")
        if isinstance(tag, int) or (isinstance(tag, str) and tag.isdigit()):
            self._saved.append(path)
            if self.max_checkpoints > 0 and len(self._saved) > self.max_checkpoints:
                victim = self._saved.pop(0)
                if main:
                    shutil.rmtree(victim, ignore_errors=True)
        return path

    def restore(self, tag) -> Optional[Dict]:
        """The tree saved under ``tag``, or None when there is none."""
        path = os.path.abspath(self.path(tag))
        if not os.path.exists(path):
            return None
        return checkpointer.restore(path)
