"""Single-query attention over the KV cache (counterpart of
``myriad_tpu/ops/decode_attention.py``).

``decode_attention`` launches kernel B2 (``csrc/decode_attention.cu``: the
cache positions of every (batch row, head) split over the blocks of one
thread-block cluster, merged in a fixed order in distributed shared memory;
one launch, no scratch) for a CUDA tensor and takes
``decode_attention_plain`` for a CPU tensor.  ``decode_attention_rows`` is
the same function through kernel B2' (the same splits, merged in a fixed
order by a second launch from a scratch tensor), the opt-in
``MYRIAD_DECODE_ATTN=row`` dispatch of ``ops/attention.py``; its plain
version is ``decode_attention_rows_plain``.  Both take any cache length
and read only its first ``kv_len`` positions, which is how a staged decode
step skips the cache's unwritten tail without a slice copy.

Where the two agree: the plain version is the ``_xla_mha`` twin (softmax,
then v_scale, then probabilities cast to q's dtype before p.V); the kernel
follows the TPU kernel (v_scale before p.V, fp32 throughout, the division by
the denominator last).  With fp32 q the plain version equals JAX's XLA path,
which is what JAX runs on the CPU; with bf16 q the two differ by bf16
rounding of the probabilities.
"""

from __future__ import annotations

import ctypes
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


def cluster_launch(b: int, h: int, kv_len: int, int8: bool = True) -> dict:
    """Kernel B2's launch at these widths (D = 128), asked of the card:
    ``splits`` (the blocks of one (b, h)'s cluster), ``smem`` (a block's
    dynamic shared memory, bytes) and ``clusters`` (how many of them the card
    holds at once; 0 with one split, which launches no cluster)."""
    out = (ctypes.c_int * 3)()
    _cuda.check(_cuda.library().myriad_decode_attention_launch_info(b, h, kv_len, int(int8), out),
                "decode_attention launch info")
    return {"splits": out[0], "smem": out[1], "clusters": out[2]}


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
    # every check runs on every decode step of every layer: each is one
    # comparison, and its message is built only when it fails
    b, h, tq, d = q.shape
    quant = k_scale is not None
    if tq != 1:
        raise ValueError(f"decode_attention takes one query row, got {tq}")
    if quant != (v_scale is not None):
        raise ValueError("an int8 cache needs both k_scale and v_scale")
    t = kv_len if kv_len is not None else k.shape[2]
    if not 1 <= t <= k.shape[2]:
        raise ValueError(f"kv_len {t} outside the cache's {k.shape[2]}")
    if rows and not rows_supported(t, d):
        raise ValueError(f"kernel B2' takes D <= {MAX_HEAD_DIM}, a multiple of 4; got D={d}")
    scale = scale if scale is not None else d ** -0.5
    if not q.is_cuda:
        return decode_attention_plain(q, k, v, mask=mask, scale=scale, k_scale=k_scale,
                                      v_scale=v_scale, kv_len=t)

    dev = q.device
    if q.dtype != torch.bfloat16:
        raise ValueError(f"decode kernel takes bf16 q, got {q.dtype}")
    if not k.dtype == v.dtype == (torch.int8 if quant else torch.bfloat16):
        raise ValueError(f"cache must be int8 with scales or bf16, got {k.dtype}/{v.dtype}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != h or k.shape[3] != d:
        raise ValueError(f"cache shape {tuple(k.shape)} vs q {tuple(q.shape)}")
    if d % 4 or d > MAX_HEAD_DIM:
        raise ValueError(f"decode kernel needs D % 4 == 0 and D <= {MAX_HEAD_DIM}, got {d}")
    st = k.stride()
    if st != v.stride() or st[3] != 1 or (st[0] | st[1] | st[2]) % 4:
        raise ValueError(f"K and V need one layout with a contiguous, 4-aligned last dim, "
                         f"got {st} / {v.stride()}")
    if (k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("cache must be 16-byte aligned")
    if k.device != dev or v.device != dev:
        raise ValueError("q and cache on one device")
    if quant:
        sc = k_scale.stride()
        if (k_scale.dtype != torch.float16 or v_scale.dtype != torch.float16
                or sc != v_scale.stride() or k_scale.shape != (b, h, k.shape[2], 1)
                or v_scale.shape != k_scale.shape or k_scale.device != dev
                or v_scale.device != dev):
            raise ValueError("k_scale/v_scale must be fp16 (B, H, T, 1) with one layout, "
                             "on q's device")
    else:
        sc = (0, 0, 0, 0)
    if mask is not None:
        if mask.dim() != 4 or mask.shape[1:] != (1, 1, t) or mask.device != dev:
            raise ValueError(f"mask must be (B, 1, 1, {t}) on q's device, got "
                             f"{tuple(mask.shape)}")
        if mask.dtype != torch.float32 or mask.shape[0] != b or not mask.is_contiguous():
            mask = mask.float().expand(b, 1, 1, t).contiguous()
    q = q.contiguous()
    out = torch.empty_like(q)
    lib = _cuda.library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
            mask.data_ptr() if mask is not None else None, out.data_ptr(), b, h, d, t,
            st[0], st[1], st[2], sc[0], sc[1], sc[2], int(quant), float(scale))
    if rows:  # the splits' partial rows
        n = _cuda.scratch_floats("myriad_decode_attention_rows_scratch", b, h, d, t)
        scratch = torch.empty(n, dtype=torch.float32, device=dev) if n else None
        err = lib.myriad_decode_attention_rows(
            *args, scratch.data_ptr() if n else None, _cuda.stream_ptr(dev))
    else:  # one launch, no scratch
        err = lib.myriad_decode_attention(*args, _cuda.stream_ptr(dev))
    _cuda.check(err, "decode_attention_rows" if rows else "decode_attention")
    (counter_rows if rows else counter).count += 1
    return out
