"""Sharding rules for parameter state dicts (counterpart of
``myriad_tpu/parallel/partition.py``).

The JAX package assigns each parameter a ``PartitionSpec`` by matching its
'/'-joined tree path against ordered regex rules, and GSPMD places the
shards.  The port keeps its own copy of those rule tables: a rule is
(pattern, spec), the spec a tuple over the dims of the JAX layout, each
``MODEL`` (split over the model axis) or None (whole), the empty tuple for a
replicated leaf.  Patterns match the path that
``convert_from_jax.jax_path_of_name`` gives a port parameter, so the same
table serves both packages.  ``shard_state_dict`` cuts a full state dict (the
port's layout: Dense weights (out, in)) down to one rank's piece, the piece
that the JAX array's shard on that model index holds.

Megatron-style over the ``model`` axis (``LLAMA_RULES``): attention q/k/v
and MLP gate/up are column parallel (output features split), attention o
and MLP down row parallel (input features split); an int8 ``scale`` follows
the output features (split for column parallel, whole for row parallel);
``lora_b`` is split over its outputs and ``lora_a`` whole; ``embed_tokens``
is split over hidden and ``lm_head`` over the vocabulary.  Norms and
everything unmatched stay whole.  The towers' tables (``VIT_RULES``,
``IMAGEBIND_RULES``, ``QFORMER_RULES`` and ``myriad_rules``) are kept for
the slice that shards them; the port serves and trains them whole.

Training cuts and gathers by the dims ``split_dims`` records when a model is
sharded: ``cut_state`` takes a whole trainable or optimizer tree (a ring's)
to this rank's pieces, ``gather_state`` the pieces back to whole tensors
over the model group (the ring is written whole, as the JAX runner's
``np.asarray`` gathers it).  ``partial_grad`` names the replicated leaves
whose gradient each rank of a group holds a part of (``lora_a``, inside the
column-parallel region), which the runner sums over the group.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from myriad_tpu_torch.convert_from_jax import jax_path_of_name

MODEL = "model"
Spec = Tuple[Optional[str], ...]
Rule = Tuple[str, Spec]

COLUMN: Spec = (None, MODEL)
ROW: Spec = (MODEL, None)
REPLICATED: Spec = ()

LLAMA_RULES: List[Rule] = [
    # q/v are LoraDense-wrapped ('base'), k is a plain Dense
    (r"(q_proj|v_proj)/base/kernel$", COLUMN),
    (r"(q_proj|k_proj|v_proj)/kernel$", COLUMN),
    (r"(gate_proj|up_proj)/kernel$", COLUMN),
    (r"o_proj/kernel$", ROW),
    (r"down_proj/kernel$", ROW),
    # int8 serving layout: the int8 weight shards as its float kernel; the
    # per-column scale follows the output dim (whole for row parallel)
    (r"(q_proj|v_proj)/base/w_int8$", COLUMN),
    (r"(q_proj|k_proj|v_proj)/w_int8$", COLUMN),
    (r"(gate_proj|up_proj)/w_int8$", COLUMN),
    (r"(o_proj|down_proj)/w_int8$", ROW),
    # int4 serving layout: the packed weight shards as its float kernel (a
    # nibble pair never straddles a shard; a row shard may split a group);
    # a row-parallel scale4 is whole
    (r"(q_proj|v_proj)/base/w_int4$", COLUMN),
    (r"(q_proj|k_proj|v_proj)/w_int4$", COLUMN),
    (r"(gate_proj|up_proj)/w_int4$", COLUMN),
    (r"(o_proj|down_proj)/w_int4$", ROW),
    (r"(q_proj|v_proj)/base/scale4$", COLUMN),
    (r"(q_proj|k_proj|v_proj|gate_proj|up_proj)/scale4$", COLUMN),
    (r"(o_proj|down_proj)/scale4$", REPLICATED),
    (r"(q_proj|v_proj)/base/scale$", (MODEL,)),
    (r"(q_proj|k_proj|v_proj|gate_proj|up_proj)/scale$", (MODEL,)),
    (r"(o_proj|down_proj)/scale$", REPLICATED),
    (r"embed_tokens/embedding$", COLUMN),
    (r"lm_head/kernel$", COLUMN),
    (r"lm_head$", COLUMN),
    (r"lora_a/kernel$", REPLICATED),
    (r"lora_b/kernel$", COLUMN),
]

VIT_RULES: List[Rule] = [
    (r"(qkv|q_proj|k_proj|v_proj)/kernel$", COLUMN),
    (r"(proj|o_proj)/kernel$", ROW),
    (r"fc1/kernel$", COLUMN),
    (r"fc2/kernel$", ROW),
    (r"(qkv|fc1)/w_int8$", COLUMN),
    (r"(proj|fc2)/w_int8$", ROW),
    (r"(qkv|fc1)/scale$", (MODEL,)),
    (r"(proj|fc2)/scale$", REPLICATED),
]

IMAGEBIND_RULES: List[Rule] = [
    (r"in_proj/kernel$", COLUMN),
    (r"out_proj/kernel$", ROW),
    (r"fc1/kernel$", COLUMN),
    (r"fc2/kernel$", ROW),
    (r"(in_proj|fc1)/w_int8$", COLUMN),
    (r"(out_proj|fc2)/w_int8$", ROW),
    (r"(in_proj|fc1)/scale$", (MODEL,)),
    (r"(out_proj|fc2)/scale$", REPLICATED),
]

QFORMER_RULES: List[Rule] = [
    (r"(query|key|value)/kernel$", COLUMN),
    (r"attn_out/kernel$", ROW),
    (r"intermediate\w*/kernel$", COLUMN),
    (r"output\w*/kernel$", ROW),
    (r"(query|key|value|intermediate_query)/w_int8$", COLUMN),
    (r"(attn_out|output_query)/w_int8$", ROW),
    (r"(query|key|value|intermediate_query)/scale$", (MODEL,)),
    (r"(attn_out|output_query)/scale$", REPLICATED),
]


def myriad_rules() -> List[Rule]:
    """Combined rule set for the composed Myriad model's paths."""
    rules: List[Rule] = []
    for prefix, sub in (
        (r"llama/", LLAMA_RULES),
        (r"visual_encoder/", VIT_RULES),
        (r"vision_expert/", IMAGEBIND_RULES),
        (r"qformer/", QFORMER_RULES),
    ):
        rules.extend((prefix + r".*" + pat if not pat.startswith("^") else pat, spec)
                     for pat, spec in sub)
    return rules


def spec_for(path: str, rules: Sequence[Rule]) -> Spec:
    for pattern, spec in rules:
        if re.search(pattern, path):
            return spec
    return REPLICATED


def spec_str(spec: Spec) -> str:
    """The spec as the JAX package prints its ``PartitionSpec``."""
    return "PartitionSpec" + repr(tuple(spec))


# the port's dim of each JAX dim: a Dense kernel (in, out) is stored (out,
# in), a convolution kernel (kh, kw, in, out) as (out, in, kh, kw)
_TORCH_DIM = {2: (1, 0), 4: (2, 3, 1, 0)}


def _torch_dim(path: str, ndim: int, jax_dim: int) -> int:
    if path.endswith("/kernel") and ndim in _TORCH_DIM:
        return _TORCH_DIM[ndim][jax_dim]
    return jax_dim


def _jax_shape(path: str, t: torch.Tensor) -> Tuple[int, ...]:
    if path.endswith("/kernel") and t.dim() in _TORCH_DIM:
        return tuple(t.shape[_TORCH_DIM[t.dim()][d]] for d in range(t.dim()))
    return tuple(t.shape)


def leaf_spec(path: str, t: torch.Tensor, n_model: int, rules: Sequence[Rule],
              fallbacks: Optional[List[str]] = None) -> Spec:
    """The spec ``t`` takes on a model axis of ``n_model``: its rule's, or
    replicated where the rule's rank exceeds the leaf's or ``n_model`` does
    not divide the split dim (each such fallback appended to ``fallbacks``
    in the JAX package's words)."""
    spec = spec_for(path, rules)
    if len(spec) > t.dim():
        if len(spec) and fallbacks is not None:
            fallbacks.append(f"{path}: spec {spec_str(spec)} rank > leaf rank {t.dim()}")
        return REPLICATED
    shape = _jax_shape(path, t)
    for dim, axis in enumerate(spec):
        if axis is not None and shape[dim] % n_model != 0:
            if fallbacks is not None:
                fallbacks.append(f"{path}: shape {shape} dim {dim} not divisible by "
                                 f"{n_model} ({spec_str(spec)}) — replicated")
            return REPLICATED
    return spec


def split_dims(state: Mapping[str, torch.Tensor], n_model: int, rules: Sequence[Rule],
               fallbacks: Optional[List[str]] = None) -> Dict[str, Optional[int]]:
    """The port's dim along which each leaf of ``state`` (whole, the port's
    layout) is cut on a model axis of ``n_model``, None where it stays whole
    (its rule replicates it, or falls back: appended to ``fallbacks``)."""
    out: Dict[str, Optional[int]] = {}
    for name, t in state.items():
        path = jax_path_of_name(name, t.dim())
        spec = leaf_spec(path, t, n_model, rules, fallbacks)
        dims = [_torch_dim(path, t.dim(), d) for d, axis in enumerate(spec) if axis is not None]
        out[name] = dims[0] if dims else None
    return out


def cut_state(state: Mapping[str, torch.Tensor], mesh,
              dims: Mapping[str, Optional[int]]) -> Dict[str, torch.Tensor]:
    """This rank's piece of each whole leaf of ``state`` along its ``dims``
    entry (a contiguous copy; a leaf with no dim, or none in ``dims``, is
    the same tensor)."""
    n, r = int(mesh.n_model), int(mesh.model_rank)
    out: Dict[str, torch.Tensor] = {}
    for name, t in state.items():
        d = dims.get(name)
        if d is None:
            out[name] = t
            continue
        w = t.shape[d] // n
        out[name] = t.narrow(d, r * w, w).clone(memory_format=torch.contiguous_format)
    return out


def gather_state(pieces: Mapping[str, torch.Tensor], mesh,
                 dims: Mapping[str, Optional[int]]) -> Dict[str, torch.Tensor]:
    """The inverse of ``cut_state``: each piece with a dim gathered whole over
    ``mesh``'s model group (one collective a piece; every rank of the group
    calls it, in the same order, and receives the same bits)."""
    return {name: (t if dims.get(name) is None else mesh.all_gather(t, dim=dims[name]))
            for name, t in pieces.items()}


def shard_state_dict(state: Mapping[str, torch.Tensor], mesh,
                     rules: Sequence[Rule]) -> Dict[str, torch.Tensor]:
    """This rank's piece of ``state`` (a full state dict in the port's
    layout) on ``mesh``'s model axis (``mesh.n_model``, ``mesh.model_rank``):
    each leaf, at its ``convert_from_jax.jax_path_of_name`` path, cut along
    the dim its rule splits; whole where the rule replicates it or falls back
    (a warning each; the list in ``shard_state_dict.last_fallbacks``).  A
    cut piece is a copy (the full leaf can be freed); a whole leaf is the
    same tensor."""
    fallbacks: List[str] = []
    out = cut_state(state, mesh, split_dims(state, int(mesh.n_model), rules, fallbacks))
    for msg in fallbacks:
        logging.warning("shard_state_dict replication fallback: %s", msg)
    shard_state_dict.last_fallbacks = fallbacks
    return out


shard_state_dict.last_fallbacks = []

# replicated leaves used inside a column-parallel region: each rank's
# gradient is the part of its own output columns
PARTIAL_GRAD_RULES = [r"lora_a/kernel$"]


def partial_grad(name: str, ndim: int) -> bool:
    """Whether the state entry ``name`` (replicated) gets a partial gradient
    on each rank of a model group, to be summed over the group."""
    path = jax_path_of_name(name, ndim)
    return any(re.search(p, path) for p in PARTIAL_GRAD_RULES)
