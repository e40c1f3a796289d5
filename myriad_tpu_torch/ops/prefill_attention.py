"""Causal attention of a prefill chunk over the KV cache (counterpart of
``myriad_tpu/ops/prefill_attention.py``).

``prefill_attention`` launches kernel B3 (``csrc/prefill_attention.cu``: on
the tensor cores for a chunk of 16 rows or more, keys split over blocks and
merged in a fixed order below that) for a CUDA tensor and takes
``prefill_attention_plain`` for a CPU tensor.
Causality comes from absolute query ``positions`` (key <= position), so a
later chunk sees the earlier chunks in the cache and slots at or past the
write frontier are excluded.  The kernel serves any chunk length and any
cache length: the TPU kernel's tq/Tk window does not apply.

Where the two agree: the plain version builds the -1e9 additive mask of
``models/llama.py`` and runs the ``_xla_mha`` twin, so with fp32 q it equals
JAX's XLA path (what JAX runs on the CPU) and with bf16 q the Pallas kernel,
which also casts the probabilities and V to bf16 before p.V.
"""

from __future__ import annotations

from typing import Optional

import torch

from myriad_tpu_torch.ops import _cuda
from myriad_tpu_torch.ops.attention import causal_mask, plain_mha

counter = _cuda.LaunchCounter("prefill_attention")
MAX_HEAD_DIM = 128


def prefill_attention_plain(q, k, v, positions, *, scale, k_scale=None, v_scale=None):
    return plain_mha(q, k, v, causal_mask(positions, k.shape[2]), scale, k_scale, v_scale)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      positions: torch.Tensor, *, scale: float,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, H, Tq, D); k/v (B, H, Tk, D) bf16 or int8 (+ per-position scales
    (B, H, Tk, 1)); positions (B, Tq) -> (B, H, Tq, D) in q's dtype."""
    b, h, tq, d = q.shape
    _cuda.require((k_scale is None) == (v_scale is None),
                  "an int8 cache needs both k_scale and v_scale")
    _cuda.require(tuple(positions.shape) == (b, tq),
                  f"positions must be ({b}, {tq}), got {tuple(positions.shape)}")
    if not q.is_cuda:
        return prefill_attention_plain(q, k, v, positions, scale=scale,
                                       k_scale=k_scale, v_scale=v_scale)

    quant = k_scale is not None
    tk = k.shape[2]
    _cuda.require(q.dtype == torch.bfloat16, f"prefill kernel takes bf16 q, got {q.dtype}")
    _cuda.require(k.dtype == v.dtype == (torch.int8 if quant else torch.bfloat16),
                  f"cache must be int8 with scales or bf16, got {k.dtype}/{v.dtype}")
    _cuda.require(tuple(k.shape) == tuple(v.shape) and k.shape[:2] == (b, h)
                  and k.shape[3] == d, f"cache shape {tuple(k.shape)} vs q {tuple(q.shape)}")
    _cuda.require(d <= MAX_HEAD_DIM, f"prefill kernel needs D <= {MAX_HEAD_DIM}, got {d}")
    _cuda.require(k.stride() == v.stride() and k.stride(3) == 1,
                  f"K and V need one layout with a contiguous last dim, got "
                  f"{k.stride()} / {v.stride()}")
    if quant:
        _cuda.require(k_scale.dtype == v_scale.dtype == torch.float16
                      and k_scale.stride() == v_scale.stride()
                      and tuple(k_scale.shape) == (b, h, tk, 1),
                      "k_scale/v_scale must be fp16 (B, H, Tk, 1) with one layout")
    _cuda.require(all(x.device == q.device for x in (k, v, positions)),
                  "q, cache and positions on one device")
    q = q.contiguous()
    pos = positions.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    sc = k_scale.stride() if quant else (0, 0, 0, 0)
    lib = _cuda.library()
    # a short chunk's key splits
    n = _cuda.scratch_floats("myriad_prefill_attention_scratch", b, h, tq, tk, d)
    scratch = torch.empty(n, dtype=torch.float32, device=q.device) if n else None
    err = lib.myriad_prefill_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
        pos.data_ptr(), out.data_ptr(), b, h, tq, tk, d,
        k.stride(0), k.stride(1), k.stride(2), sc[0], sc[1], sc[2],
        int(quant), float(scale), scratch.data_ptr() if n else None,
        _cuda.stream_ptr(q.device))
    _cuda.check(err, "prefill_attention")
    counter.count += 1
    return out
