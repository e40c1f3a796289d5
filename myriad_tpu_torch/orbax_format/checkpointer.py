"""Orbax checkpoint directories: ``restore`` reads what
``ocp.StandardCheckpointer`` writes, ``save`` writes what it restores.

A directory holds ``_METADATA`` (JSON): ``tree_metadata`` maps each leaf's
key path to its keys (``key_type`` 1 a sequence index, 2 a dict key) and its
``value_type`` (arrays, ``scalar``, or ``None``/``Dict``/``List``/``Tuple``
for an empty container, which carry no data), and ``use_ocdbt`` /
``use_zarr3`` say how the arrays are stored: zarr v2 arrays named by the
dotted key path, inside an OCDBT database (Orbax's default) or as plain
directories.  ``restore`` rebuilds the tree as Orbax does without a target:
dicts, lists for sequences, arrays as CPU tensors of the stored dtype (0-d
for ``np.asarray`` scalars), Python numbers for ``scalar`` leaves.
``save`` writes the plain layout, uncompressed, with the metadata files
Orbax reads.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from myriad_tpu_torch.orbax_format import zarr
from myriad_tpu_torch.orbax_format.ocdbt import DirectoryStore, OcdbtReader

SEQUENCE, DICT = 1, 2
ARRAY_TYPES = ("np.ndarray", "jax.Array")
_EMPTY = {"None": lambda: None, "Dict": dict, "List": list, "Tuple": tuple}
_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")


def is_checkpoint(path: str) -> bool:
    """Whether ``path`` is an Orbax checkpoint directory."""
    return os.path.isfile(os.path.join(path, "_METADATA"))


def _metadata(path: str) -> dict:
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.isfile(meta_path):
        raise FileNotFoundError(f"{path}: no _METADATA, so not an Orbax checkpoint directory")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise NotImplementedError(f"{path}: use_zarr3 is true; zarr v3 arrays are not read")
    return meta


def _leaf(store, name: str, value_meta: Mapping) -> Any:
    kind = value_meta.get("value_type")
    if kind in _EMPTY:
        return _EMPTY[kind]()
    if kind in ARRAY_TYPES:
        return zarr.read_array(store, name)
    if kind == "scalar":
        return zarr.read_array(store, name).item()
    raise NotImplementedError(f"{name}: value_type {kind!r} is not read")


def _to_lists(node: Any, kinds: Dict[int, int]) -> Any:
    """Turn the dicts that hold sequence entries into lists, by index."""
    if not isinstance(node, dict):
        return node
    out = {k: _to_lists(v, kinds) for k, v in node.items()}
    if kinds.get(id(node)) == SEQUENCE:
        idx = sorted(int(k) for k in out)
        if idx != list(range(len(idx))):
            raise ValueError(f"sequence entries {idx} are not 0..{len(idx) - 1}")
        return [out[str(i)] for i in idx]
    return out


def restore(path: str) -> Dict:
    """The tree of the Orbax checkpoint directory ``path``."""
    path = os.path.abspath(path)
    meta = _metadata(path)
    root: Dict = {}
    kinds: Dict[int, int] = {}  # id(container) -> key type of its entries
    store = OcdbtReader(path) if meta.get("use_ocdbt", True) else DirectoryStore(path)
    with store:
        for entry in meta["tree_metadata"].values():
            keys = [(k["key"], int(k["key_type"])) for k in entry["key_metadata"]]
            node = root
            for depth, (key, kind) in enumerate(keys):
                if kinds.setdefault(id(node), kind) != kind:
                    raise ValueError(f"{path}: {key!r} mixes dict and sequence keys")
                if depth == len(keys) - 1:
                    name = ".".join(k for k, _ in keys)
                    node[key] = _leaf(store, name, entry["value_metadata"])
                else:
                    node = node.setdefault(key, {})
    return _to_lists(root, kinds)


def _flatten(tree: Any, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(key path of (key, key_type) pairs, leaf) in the tree's order; an
    empty container or None is a leaf."""
    if isinstance(tree, Mapping) and tree:
        out = []
        for k, v in tree.items():
            out.extend(_flatten(v, prefix + ((str(k), DICT),)))
        return out
    if isinstance(tree, (list, tuple)) and tree:
        out = []
        for i, v in enumerate(tree):
            out.extend(_flatten(v, prefix + ((str(i), SEQUENCE),)))
        return out
    return [(prefix, tree)]


def _value_type(leaf: Any) -> str:
    if leaf is None:
        return "None"
    for name, cls in (("Dict", Mapping), ("List", list), ("Tuple", tuple)):
        if isinstance(leaf, cls):
            return name
    return "np.ndarray"


def save(path: str, tree: Mapping) -> str:
    """Write ``tree`` (nested dicts and lists of tensors, numpy arrays or
    Python numbers) as an Orbax checkpoint directory in the plain layout
    (``use_ocdbt: false``): one uncompressed zarr v2 array a leaf, written
    into a temporary directory that is renamed into place.  Numbers become
    0-d arrays, as ``np.asarray`` makes them.  Returns the path."""
    path = os.path.abspath(path)
    tmp = f"{path}.orbax-checkpoint-tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    start = time.time_ns()
    tree_meta = {}
    for keys, leaf in _flatten(tree):
        if not keys:
            raise ValueError("save: the tree is a single leaf; give a dict")
        kind = _value_type(leaf)
        tree_meta[str(tuple(k for k, _ in keys))] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in keys],
            "value_metadata": {"value_type": kind, "skip_deserialize": kind in _EMPTY}}
        if kind == "np.ndarray":
            value = leaf if torch.is_tensor(leaf) else np.asarray(leaf)
            zarr.write_array(tmp, ".".join(k for k, _ in keys), value)
    meta = {"tree_metadata": tree_meta, "use_ocdbt": False, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True, "custom_metadata": None}
    with open(os.path.join(tmp, "_METADATA"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": start, "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path
