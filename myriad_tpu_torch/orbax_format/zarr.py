"""zarr v2 arrays over a key-value source (an ``OcdbtReader`` or a
``DirectoryStore``), as Orbax stores each leaf of a checkpoint.

An array ``name`` is ``name/.zarray`` (JSON: shape, chunks, dtype, order,
compressor, fill_value, dimension_separator) and one key a chunk,
``name/i.j`` (``name/0`` for a 0-d array).  Chunks are C-ordered and
full-sized at the edges; a missing chunk takes the fill value (zeros for
null).  ``read_array`` returns a torch tensor, so bfloat16 leaves stay
bfloat16; ``write_array`` writes uncompressed chunks (``compressor: null``),
which Orbax restores as it restores its own.
"""

from __future__ import annotations

import itertools
import json
import math
import os
from typing import Dict

import numpy as np
import torch

from myriad_tpu_torch.orbax_format import zstd

DTYPES: Dict[str, torch.dtype] = {
    "<f4": torch.float32, "<f2": torch.float16, "bfloat16": torch.bfloat16,
    "<i8": torch.int64, "<i4": torch.int32, "|i1": torch.int8, "|u1": torch.uint8,
    "|b1": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}
_FLOATS = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}


class ZarrError(ValueError):
    """A ``.zarray`` the reader does not take, or a chunk of the wrong size."""


def _meta(store, name: str) -> dict:
    raw = store.get(f"{name}/.zarray")
    if raw is None:
        raise KeyError(f"{name}/.zarray")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise ZarrError(f"{name}: zarr_format {meta.get('zarr_format')} (the reader takes 2)")
    if meta.get("dtype") not in DTYPES:
        raise ZarrError(f"{name}: dtype {meta.get('dtype')!r} (the reader takes "
                        f"{', '.join(DTYPES)})")
    if meta.get("order", "C") != "C":
        raise ZarrError(f"{name}: order {meta.get('order')!r} (the reader takes C)")
    if meta.get("filters"):
        raise ZarrError(f"{name}: filters {meta['filters']!r} (the reader takes none)")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ZarrError(f"{name}: compressor {comp!r} (the reader takes zstd or null)")
    sep = meta.get("dimension_separator", ".")
    if sep not in (".", "/"):
        raise ZarrError(f"{name}: dimension_separator {sep!r}")
    if len(meta["chunks"]) != len(meta["shape"]):
        raise ZarrError(f"{name}: chunks {meta['chunks']} for shape {meta['shape']}")
    return meta


def _fill(meta: dict):
    value = meta.get("fill_value")
    if value is None:
        return 0
    if isinstance(value, str):
        if value not in _FLOATS:
            raise ZarrError(f"fill_value {value!r}")
        return _FLOATS[value]
    return value


def read_array(store, name: str) -> torch.Tensor:
    """The array ``name`` of ``store`` as a CPU tensor of its zarr dtype."""
    meta = _meta(store, name)
    dtype = DTYPES[meta["dtype"]]
    shape = [int(d) for d in meta["shape"]]
    chunks = [int(c) for c in meta["chunks"]]
    compressed = meta.get("compressor") is not None
    out = torch.empty(shape, dtype=dtype)
    if out.numel() == 0:
        return out
    itemsize = out.element_size()
    chunk_bytes = math.prod(chunks) * itemsize
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    whole = chunks == shape
    fill = _fill(meta)
    for idx in itertools.product(*grid):
        key = meta.get("dimension_separator", ".").join(map(str, idx)) if idx else "0"
        raw = store.get(f"{name}/{key}")
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        if raw is None:
            out[region] = fill
            continue
        if whole:  # the common case: one chunk, decoded straight into the tensor
            dst = out.reshape(-1).view(torch.uint8).numpy()
        else:
            dst = np.empty(chunk_bytes, dtype=np.uint8)
        if compressed:
            zstd.decompress(raw, chunk_bytes, out=dst)
        else:
            if len(raw) != chunk_bytes:
                raise ZarrError(f"{name}/{key}: {len(raw)} bytes for a chunk of {chunk_bytes}")
            dst[:] = np.frombuffer(raw, dtype=np.uint8)
        if not whole:
            chunk = torch.from_numpy(dst).view(dtype).reshape(chunks)
            out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    return out


def write_array(root: str, name: str, value) -> None:
    """Write ``value`` (a tensor or numpy array) as the uncompressed zarr v2
    array ``root/name``: one chunk of the whole array."""
    t = value.detach().cpu() if torch.is_tensor(value) else torch.from_numpy(np.asarray(value))
    if t.dtype not in _NAMES:
        raise ZarrError(f"{name}: dtype {t.dtype} has no zarr name here ({', '.join(DTYPES)})")
    t = t.contiguous()
    shape = list(t.shape)
    meta = {"chunks": shape, "compressor": None, "dimension_separator": ".",
            "dtype": _NAMES[t.dtype], "fill_value": None, "filters": None, "order": "C",
            "shape": shape, "zarr_format": 2}
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, ".zarray"), "w") as f:
        json.dump(meta, f)
    if t.numel() == 0:
        return
    key = ".".join("0" for _ in shape) if shape else "0"
    with open(os.path.join(d, key), "wb") as f:
        f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))

