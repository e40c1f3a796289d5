"""In-place KV-cache writes at per-row start positions (counterpart of
``myriad_tpu/ops/kv_write.py``), kernel B4.

Every cache write of the LLM goes through here: a prefill chunk, a decode
step and a speculative verify round alike.  ``idx`` is a Python int (every
row starts there) or a (B,) int tensor of per-row starts, the frontiers that
speculative decoding's ragged acceptance leaves behind.  Starts are clamped
to [0, T - t], as the TPU kernel clamps them (``dynamic_update_slice``'s
rule for the starts >= 0 that cache frontiers are).

- ``kv_cache_write(buf, upd, idx)`` copies ``upd`` (B, H, t, D) into ``buf``
  (B, H, T, D), any dtype and any D.
- ``kv_quantize_write(k_buf, v_buf, k_scale, v_scale, k, v, idx)`` is the
  int8 cache's write: it quantizes K and V exactly as ``quantize_kv`` does
  and writes the int8 payloads and the fp16 per-position scales, in one
  launch on the card.

Each launches ``csrc/kv_write.cu`` for CUDA tensors and takes its plain
version (``quantize_kv`` and indexed assignment) for CPU tensors.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from myriad_tpu_torch.ops import _cuda

counter = _cuda.LaunchCounter("kv_write")
Index = Union[int, torch.Tensor]


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the head dim: x (B,H,T,D) -> (x8, scale (B,H,T,1) fp32)."""
    xf = x.float()
    # divide by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which can differ from the division (the
    # JAX package's and kernel B4's) in the last bit
    div = torch.full((), 127.0, dtype=torch.float32, device=x.device)
    scale = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True) / div, 1e-8)
    x8 = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return x8, scale


def _check_index(buf: torch.Tensor, upd: torch.Tensor, idx: Index) -> None:
    b, t = upd.shape[0], upd.shape[2]
    _cuda.require(buf.dim() == 4 and upd.dim() == 4 and buf.shape[0] == b
                  and buf.shape[1] == upd.shape[1] and buf.shape[3] == upd.shape[3],
                  f"update {tuple(upd.shape)} does not fit cache {tuple(buf.shape)}")
    _cuda.require(1 <= t <= buf.shape[2], f"{t} positions do not fit {buf.shape[2]}")
    if torch.is_tensor(idx):
        _cuda.require(tuple(idx.shape) == (b,) and not idx.is_floating_point(),
                      f"per-row starts must be a ({b},) int tensor, got "
                      f"{idx.dtype} {tuple(idx.shape)}")


def kv_cache_write_plain(buf: torch.Tensor, upd: torch.Tensor, idx: Index) -> torch.Tensor:
    """Plain B4, copy mode: indexed assignment at the clamped starts."""
    _check_index(buf, upd, idx)
    b, _, t, _ = upd.shape
    hi = buf.shape[2] - t
    upd = upd.to(buf.dtype)
    if not torch.is_tensor(idx):
        s = min(max(int(idx), 0), hi)
        buf[:, :, s:s + t] = upd
        return buf
    start = idx.to(device=buf.device, dtype=torch.int64).clamp(0, hi)
    rows = torch.arange(b, device=buf.device)[:, None].expand(b, t)
    cols = start[:, None] + torch.arange(t, device=buf.device)[None, :]
    buf[rows, :, cols] = upd.transpose(1, 2)  # (B, t, H, D) at (row, col)
    return buf


def kv_quantize_write_plain(k_buf, v_buf, k_scale, v_scale, k, v, idx: Index) -> None:
    """Plain B4, quantize mode: ``quantize_kv`` then four indexed assignments."""
    for buf, sbuf, x in ((k_buf, k_scale, k), (v_buf, v_scale, v)):
        x8, s = quantize_kv(x)
        kv_cache_write_plain(buf, x8, idx)
        kv_cache_write_plain(sbuf, s, idx)


def _launch_index(idx: Index, device) -> Tuple[int, int]:
    """(pointer to per-row int32 starts or 0, the broadcast start)."""
    if not torch.is_tensor(idx):
        return 0, int(idx)
    _cuda.require(idx.device == device and idx.dtype == torch.int32 and idx.is_contiguous(),
                  "per-row starts on the card must be a contiguous int32 tensor beside "
                  "the cache")
    return idx.data_ptr(), 0


def _byte_strides(x: torch.Tensor) -> Tuple[int, int, int]:
    e = x.element_size()
    return x.stride(0) * e, x.stride(1) * e, x.stride(2) * e


def kv_cache_write(buf: torch.Tensor, upd: torch.Tensor, idx: Index) -> torch.Tensor:
    """Write ``upd`` (B, H, t, D) into ``buf`` (B, H, T, D) in place at the
    starts ``idx`` clamped to [0, T - t]; returns ``buf``.  A CPU tensor takes
    the plain version; a CUDA tensor launches kernel B4 or raises."""
    if not buf.is_cuda:
        return kv_cache_write_plain(buf, upd, idx)
    _check_index(buf, upd, idx)
    b, h, t, d = upd.shape
    _cuda.require(upd.dtype == buf.dtype, f"update {upd.dtype} into a {buf.dtype} cache")
    _cuda.require(upd.device == buf.device, "cache and update on one device")
    _cuda.require(buf.stride(3) == 1 and upd.stride(3) == 1,
                  "cache and update need a contiguous last dim")
    idx_ptr, start = _launch_index(idx, buf.device)
    lib = _cuda.library()
    err = lib.myriad_kv_write(buf.data_ptr(), upd.data_ptr(), idx_ptr, start, b, h, t,
                              buf.shape[2], d * buf.element_size(), *_byte_strides(buf),
                              *_byte_strides(upd), _cuda.stream_ptr(buf.device))
    _cuda.check(err, "kv_write")
    counter.count += 1
    return buf


def kv_quantize_write(k_buf: torch.Tensor, v_buf: torch.Tensor, k_scale: torch.Tensor,
                      v_scale: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      idx: Index) -> None:
    """Quantize K and V (B, H, t, D) as ``quantize_kv`` does and write the
    int8 payloads into ``k_buf``/``v_buf`` (B, H, T, D) and the fp16 scales
    into ``k_scale``/``v_scale`` (B, H, T, 1), in place, at the clamped
    starts ``idx``.  CPU tensors take the plain version; CUDA tensors launch
    kernel B4 once (bf16 K and V) or raise."""
    if not k_buf.is_cuda:
        return kv_quantize_write_plain(k_buf, v_buf, k_scale, v_scale, k, v, idx)
    _check_index(k_buf, k, idx)
    b, h, t, d = k.shape
    _cuda.require(k.dtype == v.dtype == torch.bfloat16,
                  f"the quantizing write takes bf16 K and V, got {k.dtype}/{v.dtype}")
    _cuda.require(k_buf.dtype == v_buf.dtype == torch.int8
                  and k_scale.dtype == v_scale.dtype == torch.float16,
                  "the quantizing write fills int8 payloads and fp16 scales")
    _cuda.require(tuple(v.shape) == tuple(k.shape) and v.stride() == k.stride()
                  and k.stride(3) == 1, "K and V need one shape and one layout with a "
                  "contiguous last dim")
    _cuda.require(tuple(v_buf.shape) == tuple(k_buf.shape) and v_buf.stride() == k_buf.stride()
                  and k_buf.stride(3) == 1, "the K and V payloads need one layout with a "
                  "contiguous last dim")
    sshape = tuple(k_buf.shape[:3]) + (1,)
    _cuda.require(tuple(k_scale.shape) == sshape == tuple(v_scale.shape)
                  and k_scale.stride() == v_scale.stride(),
                  f"scales must be {sshape} with one layout")
    _cuda.require(all(x.device == k_buf.device for x in (v_buf, k_scale, v_scale, k, v)),
                  "caches and updates on one device")
    idx_ptr, start = _launch_index(idx, k_buf.device)
    lib = _cuda.library()
    err = lib.myriad_kv_quantize_write(
        k_buf.data_ptr(), v_buf.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        k.data_ptr(), v.data_ptr(), idx_ptr, start, b, h, t, k_buf.shape[2], d,
        k_buf.stride(0), k_buf.stride(1), k_buf.stride(2),
        k_scale.stride(0), k_scale.stride(1), k_scale.stride(2),
        k.stride(0), k.stride(1), k.stride(2), _cuda.stream_ptr(k_buf.device))
    _cuda.check(err, "kv_quantize_write")
    counter.count += 1
