"""Single-query attention over the KV cache (counterpart of
``myriad_tpu/ops/decode_attention.py``).

``decode_attention`` launches kernel B2 (``csrc/decode_attention.cu``, one
block per (batch row, head)) for a CUDA tensor and takes
``decode_attention_plain`` for a CPU tensor.  ``decode_attention_rows`` is
the same function through kernel B2' (the cache positions of every (batch
row, head) split over blocks, then a fixed-order merge; any cache length),
the opt-in ``MYRIAD_DECODE_ATTN=row`` dispatch of ``ops/attention.py``; its
plain version is ``decode_attention_rows_plain``.  All read only the
first ``kv_len`` cache positions, which is how a staged decode step skips
the cache's unwritten tail without a slice copy.

Where the two agree: the plain version is the ``_xla_mha`` twin (softmax,
then v_scale, then probabilities cast to q's dtype before p.V); the kernel
follows the TPU kernel (v_scale before p.V, fp32 throughout, the division by
the denominator last).  With fp32 q the plain version equals JAX's XLA path,
which is what JAX runs on the CPU; with bf16 q the two differ by bf16
rounding of the probabilities.
"""

from __future__ import annotations

from typing import Optional

import torch

from myriad_tpu_torch.ops import _cuda
from myriad_tpu_torch.ops.attention import plain_mha

counter = _cuda.LaunchCounter("decode_attention")
counter_rows = _cuda.LaunchCounter("decode_attention_rows")
MAX_HEAD_DIM = 128


def decode_attention_plain(q, k, v, *, mask=None, scale=None, k_scale=None,
                           v_scale=None, kv_len=None):
    t = kv_len if kv_len is not None else k.shape[2]
    k, v = k[:, :, :t], v[:, :, :t]
    if k_scale is not None:
        k_scale, v_scale = k_scale[:, :, :t], v_scale[:, :, :t]
    return plain_mha(q, k, v, mask, scale, k_scale, v_scale)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     mask: Optional[torch.Tensor] = None, scale: Optional[float] = None,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     kv_len: Optional[int] = None) -> torch.Tensor:
    """q (B, H, 1, D); k/v (B, H, T, D) bf16 or int8 with per-position scales
    (B, H, T, 1); additive mask broadcastable to (B, 1, 1, kv_len) -> (B, H, 1, D)."""
    return _decode(q, k, v, mask, scale, k_scale, v_scale, kv_len, rows=False)


# B2' computes B2's function, so its plain version is B2's
decode_attention_rows_plain = decode_attention_plain


def rows_supported(kv_len: int, d: int) -> bool:
    """Whether kernel B2' takes this width: D at most 128 and a multiple of
    4, as for B2.  Any ``kv_len``: the kernel streams the cache through
    fixed-size tiles."""
    return d % 4 == 0 and d <= MAX_HEAD_DIM


def decode_attention_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          mask: Optional[torch.Tensor] = None, scale: Optional[float] = None,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None,
                          kv_len: Optional[int] = None) -> torch.Tensor:
    """``decode_attention`` through kernel B2' (positions split over blocks)
    on the card; raises where ``rows_supported`` is False, on the CPU too."""
    return _decode(q, k, v, mask, scale, k_scale, v_scale, kv_len, rows=True)


def _decode(q, k, v, mask, scale, k_scale, v_scale, kv_len, rows: bool) -> torch.Tensor:
    b, h, tq, d = q.shape
    _cuda.require(tq == 1, f"decode_attention takes one query row, got {tq}")
    _cuda.require((k_scale is None) == (v_scale is None),
                  "an int8 cache needs both k_scale and v_scale")
    t = kv_len if kv_len is not None else k.shape[2]
    _cuda.require(1 <= t <= k.shape[2], f"kv_len {t} outside the cache's {k.shape[2]}")
    _cuda.require(not rows or rows_supported(t, d),
                  f"kernel B2' takes D <= {MAX_HEAD_DIM}, a multiple of 4; got D={d}")
    scale = scale if scale is not None else d ** -0.5
    if not q.is_cuda:
        return decode_attention_plain(q, k, v, mask=mask, scale=scale, k_scale=k_scale,
                                      v_scale=v_scale, kv_len=t)

    quant = k_scale is not None
    _cuda.require(q.dtype == torch.bfloat16, f"decode kernel takes bf16 q, got {q.dtype}")
    _cuda.require(k.dtype == v.dtype == (torch.int8 if quant else torch.bfloat16),
                  f"cache must be int8 with scales or bf16, got {k.dtype}/{v.dtype}")
    _cuda.require(tuple(k.shape) == tuple(v.shape) and k.shape[:2] == (b, h)
                  and k.shape[3] == d, f"cache shape {tuple(k.shape)} vs q {tuple(q.shape)}")
    _cuda.require(d % 4 == 0 and d <= MAX_HEAD_DIM,
                  f"decode kernel needs D % 4 == 0 and D <= {MAX_HEAD_DIM}, got {d}")
    _cuda.require(k.stride() == v.stride() and k.stride(3) == 1
                  and all(s % 4 == 0 for s in k.stride()[:3]),
                  f"K and V need one layout with a contiguous, 4-aligned last dim, "
                  f"got {k.stride()} / {v.stride()}")
    _cuda.require(k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0,
                  "cache must be 16-byte aligned")
    if quant:
        _cuda.require(k_scale.dtype == v_scale.dtype == torch.float16
                      and k_scale.stride() == v_scale.stride()
                      and tuple(k_scale.shape) == (b, h, k.shape[2], 1),
                      "k_scale/v_scale must be fp16 (B, H, T, 1) with one layout")
    _cuda.require(all(x.device == q.device for x in (k, v)), "q and cache on one device")
    q = q.contiguous()
    if mask is None:
        mask = torch.zeros((b, t), dtype=torch.float32, device=q.device)
    else:
        _cuda.require(mask.shape[-1] == t and mask.dim() == 4 and mask.shape[1] == 1
                      and mask.shape[2] == 1, f"mask must be (B, 1, 1, {t}), got "
                      f"{tuple(mask.shape)}")
        mask = mask.float().expand(b, 1, 1, t).reshape(b, t).contiguous()
    out = torch.empty_like(q)
    sc = k_scale.stride() if quant else (0, 0, 0, 0)
    lib = _cuda.library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
            mask.data_ptr(), out.data_ptr(), b, h, d, t,
            k.stride(0), k.stride(1), k.stride(2), sc[0], sc[1], sc[2],
            int(quant), float(scale))
    if rows:  # the splits' partial rows
        n = _cuda.scratch_floats("myriad_decode_attention_rows_scratch", b, h, d, t)
        scratch = torch.empty(n, dtype=torch.float32, device=q.device) if n else None
        err = lib.myriad_decode_attention_rows(
            *args, scratch.data_ptr() if n else None, _cuda.stream_ptr(q.device))
    else:
        err = lib.myriad_decode_attention(*args, _cuda.stream_ptr(q.device))
    _cuda.check(err, "decode_attention_rows" if rows else "decode_attention")
    (counter_rows if rows else counter).count += 1
    return out
