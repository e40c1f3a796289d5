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


def _check_index(buf: torch.Tensor, upd: torch.Tensor, idx: Index) -> int:
    """Check that ``upd`` fits ``buf`` and ``idx`` its rows; returns T.  A
    decode step calls this at every layer: each check is a comparison, and
    its message is built only when it fails."""
    shape, bshape = upd.shape, buf.shape
    if len(shape) != 4 or len(bshape) != 4 or shape[0] != bshape[0] \
            or shape[1] != bshape[1] or shape[3] != bshape[3]:
        raise ValueError(f"update {tuple(shape)} does not fit cache {tuple(bshape)}")
    if not 1 <= shape[2] <= bshape[2]:
        raise ValueError(f"{shape[2]} positions do not fit {bshape[2]}")
    if isinstance(idx, torch.Tensor) and (idx.shape != shape[:1] or idx.is_floating_point()):
        raise ValueError(f"per-row starts must be a ({shape[0]},) int tensor, got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    return bshape[2]


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
    if not isinstance(idx, torch.Tensor):
        return 0, int(idx)
    if idx.dtype != torch.int32 or idx.device != device or not idx.is_contiguous():
        raise ValueError("per-row starts on the card must be a contiguous int32 tensor beside "
                         "the cache")
    return idx.data_ptr(), 0


def kv_cache_write(buf: torch.Tensor, upd: torch.Tensor, idx: Index) -> torch.Tensor:
    """Write ``upd`` (B, H, t, D) into ``buf`` (B, H, T, D) in place at the
    starts ``idx`` clamped to [0, T - t]; returns ``buf``.  A CPU tensor takes
    the plain version; a CUDA tensor launches kernel B4 or raises.  The
    kernel takes a cache whose positions are rows one after the other
    (strides (*, *, D, 1)) and an update with a contiguous last dim."""
    if not buf.is_cuda:
        return kv_cache_write_plain(buf, upd, idx)
    T = _check_index(buf, upd, idx)
    b, h, t, d = upd.shape
    if upd.dtype != buf.dtype:
        raise ValueError(f"update {upd.dtype} into a {buf.dtype} cache")
    dev = buf.device
    if upd.device != dev:
        raise ValueError("cache and update on one device")
    buf_sb, buf_sh, buf_st, buf_sd = buf.stride()
    upd_sb, upd_sh, upd_st, upd_sd = upd.stride()
    if buf_sd != 1 or buf_st != d or upd_sd != 1:
        raise ValueError(f"the kernel takes a cache of strides (*, *, {d}, 1) and an update "
                         f"with a contiguous last dim, got {buf.stride()} and {upd.stride()}")
    idx_ptr, start = _launch_index(idx, dev)
    err = _cuda.library().myriad_kv_write(
        buf.data_ptr(), upd.data_ptr(), idx_ptr, start, b, h, t, T, d, buf.element_size(),
        buf_sb, buf_sh, upd_sb, upd_sh, upd_st, _cuda.stream_ptr(dev))
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
    kernel B4 once (bf16 K and V) or raise.  The kernel takes payloads whose
    positions are rows one after the other (strides (sb, sh, D, 1), K's and
    V's alike), scales of strides (sb / D, sh / D, 1, *) as ``init_cache``
    makes them, and K and V of one layout with a contiguous last dim."""
    if not k_buf.is_cuda:
        return kv_quantize_write_plain(k_buf, v_buf, k_scale, v_scale, k, v, idx)
    T = _check_index(k_buf, k, idx)
    shape, cshape = k.shape, k_buf.shape
    b, h, t, d = shape
    if k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise ValueError(f"the quantizing write takes bf16 K and V, got {k.dtype}/{v.dtype}")
    if k_buf.dtype != torch.int8 or v_buf.dtype != torch.int8 \
            or k_scale.dtype != torch.float16 or v_scale.dtype != torch.float16:
        raise ValueError("the quantizing write fills int8 payloads and fp16 scales")
    x_strides, c_strides, s_strides = k.stride(), k_buf.stride(), k_scale.stride()
    x_sb, x_sh, x_st, x_sd = x_strides
    c_sb, c_sh, c_st, c_sd = c_strides
    s_sb, s_sh, s_st, _ = s_strides
    if v.shape != shape or v.stride() != x_strides or x_sd != 1:
        raise ValueError("K and V need one shape and one layout with a contiguous last dim")
    if v_buf.shape != cshape or v_buf.stride() != c_strides or c_sd != 1 or c_st != d:
        raise ValueError(f"the K and V payloads need one layout of strides (*, *, {d}, 1)")
    if k_scale.shape != (b, h, T, 1) or v_scale.shape != (b, h, T, 1) \
            or v_scale.stride() != s_strides or s_st != 1 or s_sb * d != c_sb or s_sh * d != c_sh:
        raise ValueError(f"scales must be {(b, h, T, 1)} with one layout, strides "
                         f"(sb / {d}, sh / {d}, 1) of the payload's")
    dev = k_buf.device
    if v_buf.device != dev or k_scale.device != dev or v_scale.device != dev \
            or k.device != dev or v.device != dev:
        raise ValueError("caches and updates on one device")
    idx_ptr, start = _launch_index(idx, dev)
    err = _cuda.library().myriad_kv_quantize_write(
        k_buf.data_ptr(), v_buf.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        k.data_ptr(), v.data_ptr(), idx_ptr, start, b, h, t, T, d, c_sb, c_sh,
        x_sb, x_sh, x_st, _cuda.stream_ptr(dev))
    _cuda.check(err, "kv_quantize_write")
    counter.count += 1

