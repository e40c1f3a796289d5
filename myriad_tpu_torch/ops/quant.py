"""Int8 and int4 weight quantization and the matrix products of the frozen LLM.

Counterpart of ``myriad_tpu/ops/quant.py``.  Int8 weights are stored (in,
out) with one fp32 scale per output column; int4 weights pack two input rows
per uint8 byte (in/2, out) with one fp32 scale per (group of ``int4_group``
input rows, output column), as in the JAX package.

``int8_matmul`` keeps the JAX row rule: rows <= ``SMALL_M`` on the card go to
the hand-written weight-only kernel (B1, ``csrc/int8_matmul.cu``, the
counterpart of the TPU's Pallas kernel); larger row counts, and every row
count on the CPU, take the W8A8 product (``w8a8_matmul``: per-row
activation quant and an int32 sum), which the JAX package leaves to XLA and
the port to ``torch._int_mm`` on the card.  Under autograd both routes take
the JAX package's straight-through derivative (``StraightThroughInt8``):
the backward treats the layer as x @ dequant(W), and W and its scale get no
gradient; a row-parallel shard's backward is its own rows' (no collective).
``int4_matmul`` has the same
rule with kernel B5 (``csrc/int4_matmul.cu``) for the small row counts; the
other route requantizes the int4 groups to per-column int8 at each call, as
the JAX package does off the TPU, and runs W8A8.

Row-parallel shards (a ``mesh`` given to ``int8_matmul`` or ``int4_matmul``:
x holds this rank's slice of the input features; an int4 shard may start or
end inside a group, ``int4_row_groups``) sum over the model group before
any rounding: the kernels' fp32-output mode gives fp32 partials,
summed over the ranks and rounded once; the W8A8 route takes the row's
amax over the ranks (a MAX all-reduce, so every rank quantizes x as the
unsharded product would) and sums the int32 accumulators, exactly.

``quantize_tree`` turns a float parameter tree in the JAX package's layout
(nested dicts of numpy arrays) into its serving layout, as that package's
``quantize_tree`` does, byte for byte: the weights loaders quantize each
tower with it on load.
"""

from __future__ import annotations

import ctypes
import re
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from myriad_tpu_torch.ops import _cuda

SMALL_M = 256  # rows at or below which the card uses the weight-only kernel
counter = _cuda.LaunchCounter("int8_matmul")
counter4 = _cuda.LaunchCounter("int4_matmul")
# calls of torch._int_mm (the W8A8 route on the card): a library call, not a
# kernel of the port, counted so that a path's products can be told apart
int_mm_counter = _cuda.LaunchCounter("torch._int_mm")
INT4_GROUP = 128


def quantize_per_channel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8: w (in, out) -> (w8, scale (out,))."""
    wf = w.float()
    scale = torch.clamp_min(wf.abs().amax(dim=0) / 127.0, 1e-8)
    w8 = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return w8, scale


def w8a8_matmul(x2: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor,
                mesh=None) -> torch.Tensor:
    """(m, d) fp32 @ int8 (d, f) with dynamic per-row activation quant -> fp32.
    With ``mesh``, a row-parallel shard: the amax and the int32 sums are
    reduced over the model group, and the result is the unsharded one."""
    x_amax = torch.clamp_min(x2.abs().amax(dim=-1, keepdim=True), 1e-8)
    if mesh is not None:
        mesh.all_reduce_(x_amax, op="max")
    x8 = torch.clamp(torch.round(x2 * (127.0 / x_amax)), -127, 127).to(torch.int8)
    if x2.is_cuda:
        m, d = x8.shape
        _cuda.require(m > 16 and d % 8 == 0 and w8.shape[1] % 8 == 0,
                      f"torch._int_mm needs m > 16 and d, f multiples of 8, got "
                      f"({m}, {d}) @ {tuple(w8.shape)}")
        acc = torch._int_mm(x8, w8.contiguous())
        int_mm_counter.count += 1
    else:
        acc = torch.matmul(x8.to(torch.int32), w8.to(torch.int32))
    if mesh is not None:
        mesh.all_reduce_(acc)
    return acc.float() * (x_amax / 127.0) * scale.float()


def int8_weight_only_matmul_plain(x2: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor,
                                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version of B1: (x @ float(W)) * scale, fp32 sum, in ``out_dtype``
    (x's dtype by default; fp32: the fp32-output mode, unrounded)."""
    return (torch.matmul(x2.float(), w8.float()) * scale.float()).to(out_dtype or x2.dtype)


def int8_weight_only_matmul(x2: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor,
                            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x2 (M, K) @ int8 W (K, N) * scale (N,) -> (M, N) in ``out_dtype`` (x2's
    dtype by default; ``torch.float32`` is the fp32-output mode, the sum x
    scale unrounded).

    A CPU tensor takes the plain version; a CUDA tensor launches kernel B1
    (bf16 x, M <= SMALL_M) or raises.  One launch and one allocation (the
    output) a call."""
    if not x2.is_cuda:
        return int8_weight_only_matmul_plain(x2, w8, scale, out_dtype)
    # every check runs at every projection of every decode step: each is a
    # comparison, and its message is built only when it fails
    m, k = x2.shape
    n = w8.shape[1]
    if x2.dtype != torch.bfloat16:
        raise ValueError(f"int8_matmul kernel takes bf16 x, got {x2.dtype}")
    if w8.dtype != torch.int8 or w8.shape[0] != k:
        raise ValueError(f"weight must be int8 ({k}, N), got {w8.dtype} {tuple(w8.shape)}")
    if scale.dtype != torch.float32 or scale.shape != (n,):
        raise ValueError(f"scale must be fp32 ({n},), got {scale.dtype} {tuple(scale.shape)}")
    if not 1 <= m <= SMALL_M or k < 1:
        raise ValueError(f"int8_matmul kernel serves 1..{SMALL_M} rows and K >= 1, got "
                         f"({m}, {k})")
    if n % 4:
        raise ValueError(f"int8_matmul kernel needs N % 4 == 0, got {n}")
    if w8.device != x2.device or scale.device != x2.device:
        raise ValueError("x, weight and scale must be on one device")
    if not (x2.is_contiguous() and w8.is_contiguous() and scale.is_contiguous()):
        raise ValueError("int8_matmul kernel takes contiguous tensors")
    if w8.data_ptr() % 16:
        raise ValueError("weight must be 16-byte aligned")
    f32 = out_dtype == torch.float32
    if not f32 and out_dtype not in (None, torch.bfloat16):
        raise ValueError(f"int8_matmul kernel writes bf16 or fp32, not {out_dtype}")
    lib = _cuda.library()
    out = torch.empty((m, n), dtype=torch.float32 if f32 else torch.bfloat16, device=x2.device)
    err = (lib.myriad_int8_matmul_f32 if f32 else lib.myriad_int8_matmul)(
        x2.data_ptr(), w8.data_ptr(), scale.data_ptr(), out.data_ptr(), m, k, n,
        _cuda.stream_ptr(x2.device))
    _cuda.check(err, "int8_matmul")
    counter.count += 1
    return out


def int8_launch(m: int, k: int, n: int) -> dict:
    """Kernel B1's launch at these widths, asked of the card: ``splits``
    (the blocks of one column tile's cluster, which split K), ``tiles`` (128
    output columns each), ``smem`` (a block's dynamic shared memory, bytes),
    ``clusters`` (how many of them the card holds at once; 0 with one split,
    which launches no cluster) and ``blocks_per_sm`` (how many of its blocks
    an SM holds at once)."""
    out = (ctypes.c_int * 5)()
    _cuda.check(_cuda.library().myriad_int8_matmul_launch_info(m, k, n, out),
                "int8_matmul launch info")
    return {"splits": out[0], "tiles": out[1], "smem": out[2], "clusters": out[3],
            "blocks_per_sm": out[4]}


def takes_kernel(x2: torch.Tensor) -> bool:
    """The row rule: rows <= SMALL_M on the card take the weight-only kernel
    (B1 or B5); more rows, and every row count on the CPU, take W8A8."""
    return x2.is_cuda and x2.shape[0] <= SMALL_M


def _int8_forward(x2: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor,
                  kernel: bool, mesh=None) -> torch.Tensor:
    """Either route of the row rule; with ``mesh`` a row-parallel shard's,
    summed over the model group before any rounding (fp32 out)."""
    if mesh is None:
        if kernel:
            return int8_weight_only_matmul(x2.contiguous(), w8, scale)
        return w8a8_matmul(x2.float(), w8, scale)
    if kernel:
        return mesh.all_reduce_(int8_weight_only_matmul(x2.contiguous(), w8, scale,
                                                        out_dtype=torch.float32))
    return w8a8_matmul(x2.float(), w8, scale, mesh=mesh)


class StraightThroughInt8(torch.autograd.Function):
    """An int8 product with the JAX package's straight-through derivative
    (``_w8a8_matmul`` and ``_int8_pallas_matmul``'s custom JVPs): the forward
    is either route of the row rule, unchanged (B1 counts its launches), a
    row-parallel shard's with ``mesh``; the backward is dx = (dy * scale) @
    w8^T, in fp32 on the CPU and in x's dtype (the compute dtype) on the
    card, and w8 and scale get no gradient.  A row shard's backward is the
    same product over its own rows of w8: dy is whole on every rank, so it
    needs no collective.  Without it the W8A8 route's rounding would give
    every upstream trainable a zero gradient."""

    @staticmethod
    def forward(ctx, x2, w8, scale, kernel, mesh=None):
        ctx.save_for_backward(w8, scale)
        ctx.x_dtype = x2.dtype
        return _int8_forward(x2, w8, scale, kernel, mesh)

    @staticmethod
    def backward(ctx, dy):
        w8, scale = ctx.saved_tensors
        dt = ctx.x_dtype if dy.is_cuda else torch.float32
        dx = torch.matmul(dy.to(dt) * scale.to(dt), w8.to(dt).t())
        return dx.to(ctx.x_dtype), None, None, None, None


def int8_matmul(x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor, *,
                out_dtype: Optional[torch.dtype] = None, mesh=None) -> torch.Tensor:
    """x (..., in) @ int8 w (in, out) * scale (out,) -> (..., out);
    differentiable in x by the straight-through rule.  With ``mesh``, a
    row-parallel shard: x and w hold this rank's input features, and the
    result is summed over the model group (B1's fp32 partials, or W8A8's
    amax and int32 sums) before its one rounding to ``out_dtype``."""
    out_dtype = out_dtype or x.dtype
    lead, d = x.shape[:-1], x.shape[-1]
    f = w8.shape[1]
    x2 = x.reshape(-1, d)
    if torch.is_grad_enabled() and x2.requires_grad:
        y = StraightThroughInt8.apply(x2, w8, scale, takes_kernel(x2), mesh)
    else:
        y = _int8_forward(x2, w8, scale, takes_kernel(x2), mesh)
    return y.to(out_dtype).reshape(*lead, f)


# ---------------------------------------------------------------------------
# int4 weight-only, group-wise (kernel B5).  Symmetric round-to-nearest int4
# with one fp32 scale per (group of INT4_GROUP input rows, output column).
# Two nibbles pack per uint8 byte along the input dim: input row 2i is the
# low nibble of packed row i, row 2i+1 the high one.
# ---------------------------------------------------------------------------
def int4_group(d: int) -> int:
    """Group size along the input dim: 128 when it divides, else the whole
    dim (keeps tiny test models valid)."""
    return INT4_GROUP if d % INT4_GROUP == 0 else d


def quantize_int4_grouped(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w (in, out) -> (packed (in/2, out) uint8, scale (in/group, out) fp32)."""
    d, f = w.shape
    if d % 2:
        raise ValueError(f"int4 packing needs an even input dim, got {d}")
    g = int4_group(d)
    wf = w.float().reshape(d // g, g, f)
    scale = torch.clamp_min(wf.abs().amax(dim=1, keepdim=True) / 7.0, 1e-8)
    q = torch.clamp(torch.round(wf / scale), -8, 7).to(torch.int32).reshape(d, f)
    packed = ((q[0::2] & 15) | ((q[1::2] & 15) << 4)).to(torch.uint8)
    return packed, scale.reshape(d // g, f)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(in/2, out) uint8 -> (in, out) int32 in [-8, 7]."""
    p = packed.to(torch.int32)
    lo = ((p & 15) ^ 8) - 8  # branch-free 4-bit sign extension
    hi = ((p >> 4) ^ 8) - 8
    d2, f = packed.shape
    return torch.stack([lo, hi], dim=1).reshape(d2 * 2, f)


def _group_rows(t: torch.Tensor, group: int, goff: int, groups: int) -> torch.Tensor:
    """t (K, N): a shard's rows, whose first row is row ``goff`` of its first
    group, as (groups, group, N) with zeros before it and past the last row
    (a shard that starts or ends inside a group)."""
    k = t.shape[0]
    tail = groups * group - goff - k
    if goff or tail:
        t = torch.nn.functional.pad(t, (0, 0, goff, tail))
    return t.reshape(groups, group, t.shape[-1])


def _shard_rows(t: torch.Tensor, goff: int, k: int) -> torch.Tensor:
    """The inverse of ``_group_rows``: (groups, group, N) -> the shard's (K, N)."""
    return t.reshape(-1, t.shape[-1])[goff:goff + k]


def _group_of(k: int, scale4: torch.Tensor, group: Optional[int]) -> int:
    """The group size: ``group``, or (a whole weight) the rows over the scale rows."""
    return int(group) if group else k // scale4.shape[0]


def dequant_int4(packed: torch.Tensor, scale: torch.Tensor, goff: int = 0,
                 group: Optional[int] = None) -> torch.Tensor:
    """Reference dequantization to fp32; ``goff``/``group``: a row shard's
    (its first row is row ``goff`` of the first scale row's group)."""
    q = unpack_int4(packed).float()
    d = q.shape[0]
    g = _group_of(d, scale, group)
    w = _group_rows(q, g, goff, scale.shape[0]) * scale[:, None, :].float()
    return _shard_rows(w, goff, d)


def int4_weight_only_matmul_plain(x2: torch.Tensor, w4: torch.Tensor, scale4: torch.Tensor,
                                  out_dtype: Optional[torch.dtype] = None, goff: int = 0,
                                  group: Optional[int] = None) -> torch.Tensor:
    """Plain version of B5, the TPU kernel's arithmetic: each nibble and its
    group scale go to bf16, their product is rounded to bf16 (the scale
    applies before the dot), and x @ that weight sums in fp32; the result
    is in ``out_dtype`` (x's dtype by default; fp32: unrounded).  ``goff``
    and ``group``: a row shard's group offset and group size (local row k
    is in scale row (k + goff) // group)."""
    q = unpack_int4(w4).to(torch.bfloat16)
    d = q.shape[0]
    g = _group_of(d, scale4, group)
    w = _group_rows(q, g, goff, scale4.shape[0]) * scale4.to(torch.bfloat16)[:, None, :]
    return torch.matmul(x2.float(), _shard_rows(w, goff, d).float()).to(out_dtype or x2.dtype)


def int4_weight_only_matmul(x2: torch.Tensor, w4: torch.Tensor, scale4: torch.Tensor,
                            out_dtype: Optional[torch.dtype] = None, goff: int = 0,
                            group: Optional[int] = None) -> torch.Tensor:
    """x2 (M, K) @ int4 W (K/2, N) with group scales (groups, N) -> (M, N) in
    ``out_dtype`` (x2's dtype by default; ``torch.float32`` is the
    fp32-output mode, the sum unrounded).  Local row k takes scale row (k +
    ``goff``) // ``group``: a row shard of a whole weight may start or end
    inside a group (``group`` defaults to K / groups, with no offset).

    A CPU tensor takes the plain version; a CUDA tensor launches kernel B5
    (bf16 x, M <= SMALL_M) or raises.  One launch and one allocation (the
    output) a call."""
    if not x2.is_cuda:
        return int4_weight_only_matmul_plain(x2, w4, scale4, out_dtype, goff, group)
    # every check runs at every projection of every decode step: each is a
    # comparison, and its message is built only when it fails
    m, k = x2.shape
    n = w4.shape[1]
    if x2.dtype != torch.bfloat16:
        raise ValueError(f"int4_matmul kernel takes bf16 x, got {x2.dtype}")
    if k % 2 or w4.dtype != torch.uint8 or w4.shape[0] * 2 != k:
        raise ValueError(f"weight must be uint8 ({k // 2}, N), got {w4.dtype} "
                         f"{tuple(w4.shape)}")
    groups = scale4.shape[0] if scale4.dim() == 2 else 0
    g = int(group) if group else (k // groups if groups else 0)
    # the groups cover the shard's rows: its first row is row goff of the
    # first group, its last row in the last group, and a nibble pair shares
    # one group (g and goff even)
    if (scale4.dtype != torch.float32 or groups == 0 or g < 2 or g % 2 or goff % 2
            or not 0 <= goff < g or groups != -(-(goff + k) // g) or scale4.shape[1] != n):
        raise ValueError(f"scale4 must be fp32 (groups, {n}) whose even groups of {g} cover "
                         f"the {k} rows from offset {goff}, got {scale4.dtype} "
                         f"{tuple(scale4.shape)}")
    if not 1 <= m <= SMALL_M:
        raise ValueError(f"int4_matmul kernel serves 1..{SMALL_M} rows, got {m}")
    if n % 4:
        raise ValueError(f"int4_matmul kernel needs N % 4 == 0, got {n}")
    if w4.device != x2.device or scale4.device != x2.device:
        raise ValueError("x, weight and scale4 must be on one device")
    if not (x2.is_contiguous() and w4.is_contiguous() and scale4.is_contiguous()):
        raise ValueError("int4_matmul kernel takes contiguous tensors")
    if (w4.data_ptr() | scale4.data_ptr()) % 16 or x2.data_ptr() % 4:
        raise ValueError("weight and scale4 must be 16-byte aligned, x 4-byte aligned")
    f32 = out_dtype == torch.float32
    if not f32 and out_dtype not in (None, torch.bfloat16):
        raise ValueError(f"int4_matmul kernel writes bf16 or fp32, not {out_dtype}")
    lib = _cuda.library()
    out = torch.empty((m, n), dtype=torch.float32 if f32 else torch.bfloat16, device=x2.device)
    err = (lib.myriad_int4_matmul_f32 if f32 else lib.myriad_int4_matmul)(
        x2.data_ptr(), w4.data_ptr(), scale4.data_ptr(), out.data_ptr(), m, k, n, g, goff,
        _cuda.stream_ptr(x2.device))
    _cuda.check(err, "int4_matmul")
    counter4.count += 1
    return out


def int4_launch(m: int, k: int, n: int, group: int, goff: int = 0) -> dict:
    """Kernel B5's launch at these widths, asked of the card: ``splits``
    (the blocks of one column tile's cluster, which split K), ``tiles`` (128
    output columns each), ``smem`` (a block's dynamic shared memory, bytes),
    ``clusters`` (how many of them the card holds at once; 0 with one
    split, which launches no cluster) and ``uniform`` (whether every
    128-row stage lies in one group, whose scale row comes with the stage;
    else each register's scale is looked up)."""
    out = (ctypes.c_int * 5)()
    _cuda.check(_cuda.library().myriad_int4_matmul_launch_info(m, k, n, group, goff, out),
                "int4_matmul launch info")
    return {"splits": out[0], "tiles": out[1], "smem": out[2], "clusters": out[3],
            "uniform": bool(out[4])}


def requantize_int4_to_int8(w4: torch.Tensor, scale4: torch.Tensor,
                            s_col: Optional[torch.Tensor] = None, goff: int = 0,
                            group: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int4 groups as per-column int8 (error <= the plain int8 path's):
    (w8 (in, out) int8, s_col (out,) fp32), as the JAX package computes them
    for its W8A8 route.  Its ``(max(scale) * 8) / 127`` is taken in the
    form its compiler gives it inside the jitted model, one multiply by
    fp32(8 / 127), which can differ from the two steps in the last bit.
    ``s_col`` given (a row shard's: the whole weight's column scales) is
    used as it is; ``goff`` and ``group`` map a row shard's rows to their
    groups (``int4_weight_only_matmul``'s), so every row is the whole
    weight's requantized row."""
    q = unpack_int4(w4)
    d = q.shape[0]
    g = _group_of(d, scale4, group)
    if s_col is None:
        s_col = torch.clamp_min(scale4.amax(dim=0) * (8.0 / 127.0), 1e-8)
    ratio = scale4 / s_col[None, :]
    w8 = torch.clamp(torch.round(_group_rows(q.float(), g, goff, scale4.shape[0])
                                 * ratio[:, None, :]), -127, 127).to(torch.int8)
    return _shard_rows(w8, goff, d), s_col


def int4_matmul(x: torch.Tensor, w4: torch.Tensor, scale4: torch.Tensor, *,
                out_dtype: Optional[torch.dtype] = None, mesh=None) -> torch.Tensor:
    """x (..., in) @ int4-packed w (in/2, out) with group scales (in/g, out)
    -> (..., out).  Rows <= SMALL_M on the card take kernel B5; more rows,
    and every row count on the CPU, requantize to per-column int8 (at each
    call: no int8 copy is kept) and take W8A8.  No gradient: an x that
    requires one raises.

    With ``mesh``, a row-parallel shard: x and w4 hold this rank's input
    features (which may start or end inside a group: ``int4_row_groups``),
    ``scale4`` is the whole weight's (the rules replicate it), and the
    result is summed over the model group before its one rounding (B5's
    fp32 partials; W8A8 over the whole weight's column scales, the amax and
    int32 sums reduced).  Each weight element is dequantized as the whole
    weight's, so the sum differs from the whole product only in the fp32
    sums' order (W8A8: not at all)."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError("llm_weight_dtype=int4 under training: a gradient through "
                                  "int4 weights is not ported (B5 has no derivative in the "
                                  "JAX package)")
    out_dtype = out_dtype or x.dtype
    lead, d = x.shape[:-1], x.shape[-1]
    f = w4.shape[1]
    x2 = x.reshape(-1, d)
    if mesh is not None:
        local, goff, group = int4_row_groups(scale4, d, mesh)
        if takes_kernel(x2):
            y = mesh.all_reduce_(int4_weight_only_matmul(x2.contiguous(), w4, local,
                                                         out_dtype=torch.float32, goff=goff,
                                                         group=group))
        else:
            s_col = torch.clamp_min(scale4.amax(dim=0) * (8.0 / 127.0), 1e-8)
            y = w8a8_matmul(x2.float(), *requantize_int4_to_int8(w4, local, s_col, goff, group),
                            mesh=mesh)
    elif takes_kernel(x2):
        y = int4_weight_only_matmul(x2.contiguous(), w4, scale4)
    else:
        y = w8a8_matmul(x2.float(), *requantize_int4_to_int8(w4, scale4))
    return y.to(out_dtype).reshape(*lead, f)


def int4_row_groups(scale4: torch.Tensor, k_local: int, mesh) -> Tuple[torch.Tensor, int, int]:
    """This rank's row shard of a whole weight's groups: ``k_local`` input
    rows from row ``model_rank * k_local`` of ``n_model * k_local``.  Returns
    (the rows of the whole ``scale4`` (groups, out) that the shard touches,
    a contiguous view; the group offset of its first row; the group size).
    A shard may hold a partial first group, a partial last group, or both
    (Vicuna-7B's down over 4 ranks: 2752 rows, 21.5 groups of 128)."""
    groups, n = scale4.shape[0], mesh.n_model
    whole = k_local * n
    if whole % groups:
        raise ValueError(f"int4 row shard: {groups} groups of scale4 {tuple(scale4.shape)} do "
                         f"not divide the weight's {whole} input rows ({n} x {k_local})")
    group = whole // groups
    start = mesh.model_rank * k_local
    first = start // group
    return scale4.narrow(0, first, -(-(start + k_local) // group) - first), start % group, group


# ---------------------------------------------------------------------------
# quantize-on-load over numpy trees (the JAX package's ``quantize_tree``)
# ---------------------------------------------------------------------------
LLAMA_QUANT_PATTERN = (
    r"(k_proj|o_proj|gate_proj|up_proj|down_proj)/kernel$"
    r"|(q_proj|v_proj)/base/kernel$"
)
# EVA-ViT trunk projections (attn qkv/proj + MLP) — patch_embed is 4-D
# and skipped by the ndim check
EVA_QUANT_PATTERN = r"(qkv|attn/proj|fc1|fc2)/kernel$"
# ImageBind trunk projections; head_proj (the CLIP-space head) stays bf16
IMAGEBIND_QUANT_PATTERN = r"(in_proj|out_proj|fc1|fc2)/kernel$"
# Q-Former projections (self/cross attention + query FFN)
QFORMER_QUANT_PATTERN = (
    r"(query|key|value|attn_out|intermediate_query|output_query)/kernel$"
)


def quantize_tree(params: Mapping, path_pattern: str = LLAMA_QUANT_PATTERN,
                  mode: str = "int8") -> dict:
    """Replace each 2-D ``kernel`` leaf whose '/'-joined path matches
    ``path_pattern`` by the quantized Dense layout, on the CPU in fp32 (numpy
    leaves or CPU tensors in, numpy out): ``mode`` "int8" gives {'w_int8'
    (in, out) int8, 'scale' (out,) fp32}, "int4" {'w_int4' (in/2, out)
    uint8, 'scale4' (in/group, out) fp32}.  Other leaves (a bias beside the kernel among
    them) pass through."""
    pat = re.compile(path_pattern)

    def rec(node, path=""):
        if not isinstance(node, Mapping):
            return node
        out = {}
        for k, v in node.items():
            p = f"{path}/{k}" if path else k
            if (k == "kernel" and not isinstance(v, Mapping) and np.ndim(v) == 2
                    and pat.search(p)):
                w = (v.float() if torch.is_tensor(v)
                     else torch.from_numpy(np.asarray(v, np.float32)))
                quantize = quantize_int4_grouped if mode == "int4" else quantize_per_channel
                names = ("w_int4", "scale4") if mode == "int4" else ("w_int8", "scale")
                for name, t in zip(names, quantize(w)):
                    out[name] = t.numpy()
            elif isinstance(v, Mapping):
                out[k] = rec(v, p)
            else:
                out[k] = v
        return out

    return rec(params)
