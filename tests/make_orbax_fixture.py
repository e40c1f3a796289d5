"""Write ``tests/orbax_fixture/``: a checkpoint ring the JAX package wrote, and
zstd frames libzstd wrote, for the port's Orbax reader to be held to where
neither orbax nor tensorstore is installed (the card).

* ``ring/checkpoint_1``: ``myriad_tpu.checkpoint.CheckpointManager.save`` (the
  default Orbax settings: OCDBT, zarr v2 chunks at zstd level 1) of a seeded
  stage-2 runner state: trainables with a 64 x 1024 fp32 kernel of N(0, 0.02)
  (256 KiB, Huffman-coded literals), ``make_optimizer``'s state with
  ``accum_grad_iters: 2``, ``max_grad_norm`` and bf16 ``mu`` after one update
  (the ``MultiSteps`` containers, bf16 leaves), 0-d int64 ``epoch`` and
  ``global_step``.
* ``frames/*.zst``: tensorstore's zstd chunks at levels 3 and 19 over fp32
  N(0, 0.02) weights and repeated text.
* ``expected.json``: each leaf's path, dtype, shape and the sha256 of its
  bytes; each frame's decoded size and sha256.

Run from the repository root: ``python tests/make_orbax_fixture.py``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "orbax_fixture")
SEED = 17
FRAMES = {"level3_normal": (3, "normal"), "level19_normal": (19, "normal"),
          "level3_text": (3, "text"), "level19_text": (19, "text")}


def trainables(seed: int = SEED) -> dict:
    """The stage-2 trainables of the fixture, in the JAX layout."""
    rng = np.random.default_rng(seed)
    n = lambda *shape: rng.normal(0, 0.02, shape).astype(np.float32)
    return {"llama_proj": {"kernel": n(64, 1024), "bias": n(1024)},
            "llama": {"layers_0": {"self_attn": {"q_proj": {
                "lora_a": n(64, 8), "lora_b": np.zeros((8, 64), np.float32)}}}}}


def frame_data(kind: str, seed: int = SEED) -> bytes:
    if kind == "normal":
        return np.random.default_rng(seed + 1).normal(0, 0.02, 16384).astype(np.float32).tobytes()
    words = b"the bottle has a crack near its neck; the cable is bent; no defect. "
    return (words * 1200)[:65536]


def state(seed: int = SEED) -> dict:
    """The runner state the fixture's ring holds (JAX arrays)."""
    import jax
    import jax.numpy as jnp

    from myriad_tpu.common.optim import make_optimizer

    params = jax.tree_util.tree_map(jnp.asarray, trainables(seed))
    tx = make_optimizer(lambda step: 1e-3, max_grad_norm=1.0, accum_grad_iters=2,
                        mu_dtype="bfloat16")
    opt = tx.init(params)
    grads = jax.tree_util.tree_map(lambda p: jnp.full_like(p, 0.01), params)
    _, opt = tx.update(grads, opt, params)
    return {"model": jax.tree_util.tree_map(np.asarray, params),
            "optimizer": jax.tree_util.tree_map(np.asarray, opt),
            "epoch": np.asarray(1), "global_step": np.asarray(6)}


def tensorstore_frame(data: bytes, level: int) -> bytes:
    """The zstd chunk tensorstore writes for ``data`` (one zarr chunk)."""
    import tensorstore as ts

    arr = ts.open({"driver": "zarr", "kvstore": "memory://",
                   "metadata": {"shape": [len(data)], "chunks": [len(data)], "dtype": "|u1",
                                "compressor": {"id": "zstd", "level": level}}},
                  create=True).result()
    arr[...] = np.frombuffer(data, np.uint8)
    return arr.kvstore.read("0").result().value


def leaf_bytes(leaf) -> bytes:
    """A leaf's bytes, C order (bfloat16 as its 2-byte words)."""
    a = np.asarray(leaf)
    return np.ascontiguousarray(a).tobytes()


def leaves(tree, prefix=()):
    """(key path, leaf) of an orbax-restored tree, None and empty containers
    left out."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, prefix + (str(i),))
    elif tree is not None:
        yield prefix, tree


def describe(tree) -> list:
    return [{"path": ".".join(p), "dtype": str(np.asarray(v).dtype),
             "shape": list(np.shape(v)), "sha256": hashlib.sha256(leaf_bytes(v)).hexdigest()}
            for p, v in leaves(tree)]


def main() -> None:
    sys.path.insert(0, os.path.dirname(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import orbax.checkpoint as ocp

    from myriad_tpu.checkpoint import CheckpointManager

    shutil.rmtree(OUT, ignore_errors=True)
    ring = CheckpointManager(os.path.join(OUT, "ring"))
    path = ring.save(1, state())
    restored = ocp.StandardCheckpointer().restore(path)
    os.makedirs(os.path.join(OUT, "frames"))
    frames = {}
    for name, (level, kind) in FRAMES.items():
        data = frame_data(kind)
        with open(os.path.join(OUT, "frames", f"{name}.zst"), "wb") as f:
            f.write(tensorstore_frame(data, level))
        frames[name] = {"level": level, "size": len(data),
                        "sha256": hashlib.sha256(data).hexdigest()}
    with open(os.path.join(OUT, "expected.json"), "w") as f:
        json.dump({"seed": SEED, "checkpoint": "ring/checkpoint_1",
                   "leaves": describe(restored), "frames": frames}, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
