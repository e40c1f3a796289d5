"""Int8 weight quantization and the int8 matrix products of the frozen LLM.

Counterpart of ``myriad_tpu/ops/quant.py``.  Weights are stored (in, out)
int8 with one fp32 scale per output column, as in the JAX package.

``int8_matmul`` keeps the JAX row rule: rows <= ``SMALL_M`` on the card go to
the hand-written weight-only kernel (B1, ``csrc/int8_matmul.cu``, the
counterpart of the TPU's Pallas kernel); larger row counts, and every row
count on the CPU, take the W8A8 product (``w8a8_matmul``: per-row
activation quant and an int32 sum), which the JAX package leaves to XLA and
the port to ``torch._int_mm`` on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from myriad_tpu_torch.ops import _cuda

SMALL_M = 256  # rows at or below which the card uses the weight-only kernel
counter = _cuda.LaunchCounter("int8_matmul")


def quantize_per_channel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8: w (in, out) -> (w8, scale (out,))."""
    wf = w.float()
    scale = torch.clamp_min(wf.abs().amax(dim=0) / 127.0, 1e-8)
    w8 = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return w8, scale


def w8a8_matmul(x2: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(m, d) fp32 @ int8 (d, f) with dynamic per-row activation quant -> fp32."""
    x_amax = torch.clamp_min(x2.abs().amax(dim=-1, keepdim=True), 1e-8)
    x8 = torch.clamp(torch.round(x2 * (127.0 / x_amax)), -127, 127).to(torch.int8)
    if x2.is_cuda:
        m, d = x8.shape
        _cuda.require(m > 16 and d % 8 == 0 and w8.shape[1] % 8 == 0,
                      f"torch._int_mm needs m > 16 and d, f multiples of 8, got "
                      f"({m}, {d}) @ {tuple(w8.shape)}")
        acc = torch._int_mm(x8, w8.contiguous())
    else:
        acc = torch.matmul(x8.to(torch.int32), w8.to(torch.int32))
    return acc.float() * (x_amax / 127.0) * scale.float()


def int8_weight_only_matmul_plain(x2: torch.Tensor, w8: torch.Tensor,
                                  scale: torch.Tensor) -> torch.Tensor:
    """Plain version of B1: (x @ float(W)) * scale, fp32 sum, in x's dtype."""
    return (torch.matmul(x2.float(), w8.float()) * scale.float()).to(x2.dtype)


def int8_weight_only_matmul(x2: torch.Tensor, w8: torch.Tensor,
                            scale: torch.Tensor) -> torch.Tensor:
    """x2 (M, K) @ int8 W (K, N) * scale (N,) -> (M, N) in x2's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches kernel B1
    (bf16 x, M <= SMALL_M) or raises."""
    if not x2.is_cuda:
        return int8_weight_only_matmul_plain(x2, w8, scale)
    m, k = x2.shape
    n = w8.shape[1]
    _cuda.require(x2.dtype == torch.bfloat16, f"int8_matmul kernel takes bf16 x, got {x2.dtype}")
    _cuda.require(w8.dtype == torch.int8 and w8.shape[0] == k,
                  f"weight must be int8 ({k}, N), got {w8.dtype} {tuple(w8.shape)}")
    _cuda.require(scale.dtype == torch.float32 and tuple(scale.shape) == (n,),
                  f"scale must be fp32 ({n},), got {scale.dtype} {tuple(scale.shape)}")
    _cuda.require(1 <= m <= SMALL_M, f"int8_matmul kernel serves 1..{SMALL_M} rows, got {m}")
    _cuda.require(n % 4 == 0, f"int8_matmul kernel needs N % 4 == 0, got {n}")
    _cuda.require(w8.device == x2.device and scale.device == x2.device,
                  "x, weight and scale must be on one device")
    _cuda.require(x2.is_contiguous() and w8.is_contiguous() and scale.is_contiguous(),
                  "int8_matmul kernel takes contiguous tensors")
    _cuda.require(w8.data_ptr() % 16 == 0, "weight must be 16-byte aligned")
    lib = _cuda.library()
    splits = lib.myriad_int8_matmul_splits(k)
    partial = torch.empty((splits, m, n), dtype=torch.float32, device=x2.device)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
    err = lib.myriad_int8_matmul(x2.data_ptr(), w8.data_ptr(), scale.data_ptr(),
                                 partial.data_ptr(), out.data_ptr(), m, k, n,
                                 _cuda.stream_ptr(x2.device))
    _cuda.check(err, "int8_matmul")
    counter.count += 1
    return out


def int8_matmul(x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor, *,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (..., in) @ int8 w (in, out) * scale (out,) -> (..., out)."""
    out_dtype = out_dtype or x.dtype
    lead, d = x.shape[:-1], x.shape[-1]
    f = w8.shape[1]
    x2 = x.reshape(-1, d)
    if x2.is_cuda and x2.shape[0] <= SMALL_M:
        y = int8_weight_only_matmul(x2.contiguous(), w8, scale)
    else:
        y = w8a8_matmul(x2.float(), w8, scale)
    return y.to(out_dtype).reshape(*lead, f)
