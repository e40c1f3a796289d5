"""On-device image preprocessing (counterpart of ``myriad_tpu/ops/preprocess.py``).

- ``u8_normalize`` is the plain normalisation the models call (the JAX
  package's XLA path).
- ``u8_normalize_rows`` is kernel B6 (``csrc/preprocess.cu``): uint8 (..., 3)
  -> ((x / 255) - mean[c]) / std[c] in one pass, c = flat index mod 3.  A CPU
  tensor takes ``u8_normalize_rows_plain``.
- ``device_preprocess`` mirrors the JAX function's branch order: the kernel
  only when ``use_pallas`` and no ``out_size``; otherwise the float path,
  with a bicubic resize (two matrix products, PIL's antialiased kernel) when
  ``out_size`` differs from the image's.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from myriad_tpu_torch.ops import _cuda

# CLIP statistics, copied from myriad_tpu/processors/functional.py (which
# imports PIL); tests/test_torch_myriad.py holds the copies equal.
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
counter = _cuda.LaunchCounter("u8_normalize")


def u8_normalize(images_u8: torch.Tensor, mean=CLIP_MEAN, std=CLIP_STD,
                 out_dtype=torch.float32) -> torch.Tensor:
    """uint8 (..., 3) -> ((x / 255) - mean) / std in ``out_dtype``."""
    x = images_u8.float() / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - m) / s).to(out_dtype)


def _on_device(values, device) -> torch.Tensor:
    """fp32 constants made on ``device`` by fills (no host copy, so a CUDA
    graph can capture them)."""
    return torch.stack([torch.full((), float(v), dtype=torch.float32, device=device)
                        for v in values])


def u8_normalize_rows_plain(images_u8: torch.Tensor, mean=CLIP_MEAN, std=CLIP_STD,
                            out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of B6.  Every division is by a tensor: PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal, which can
    differ from the kernel's IEEE division in the last bit."""
    dev = images_u8.device
    x = images_u8.float() / _on_device((255.0,), dev)[0]
    return ((x - _on_device(mean, dev)) / _on_device(std, dev)).to(out_dtype)


def u8_normalize_rows(images_u8: torch.Tensor, mean=CLIP_MEAN, std=CLIP_STD,
                      out_dtype=torch.float32) -> torch.Tensor:
    """uint8 (..., 3) -> normalized fp32 or bf16, kernel B6 on the card."""
    if not images_u8.is_cuda:
        return u8_normalize_rows_plain(images_u8, mean, std, out_dtype)
    # each check is a comparison, and its message is built only when it fails
    if images_u8.dtype != torch.uint8 or images_u8.dim() == 0 or images_u8.shape[-1] != 3:
        raise ValueError(f"u8_normalize kernel takes uint8 (..., 3), got {images_u8.dtype} "
                         f"{tuple(images_u8.shape)}")
    if out_dtype != torch.float32 and out_dtype != torch.bfloat16:
        raise ValueError(f"u8_normalize kernel writes fp32 or bf16, not {out_dtype}")
    if len(mean) != 3 or len(std) != 3:
        raise ValueError("mean and std need 3 channels")
    x = images_u8.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("images must be 16-byte aligned")
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    err = _cuda.library().myriad_u8_normalize(
        x.data_ptr(), out.data_ptr(), x.numel(), *map(float, mean), *map(float, std),
        int(out_dtype == torch.bfloat16), _cuda.stream_ptr(x.device))
    _cuda.check(err, "u8_normalize")
    counter.count += 1
    return out


def _cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    x = np.abs(x)
    return np.where(
        x <= 1,
        (a + 2) * x**3 - (a + 3) * x**2 + 1,
        np.where(x < 2, a * x**3 - 5 * a * x**2 + 8 * a * x - 4 * a, 0.0),
    )


@functools.lru_cache(maxsize=16)
def resize_matrix_bicubic(n_in: int, n_out: int) -> np.ndarray:
    """W (n_out, n_in): 1-D bicubic resample with half-pixel centers and
    antialias filter scaling for downsampling (PIL semantics)."""
    scale = n_in / n_out
    support_scale = max(scale, 1.0)
    centers = (np.arange(n_out) + 0.5) * scale - 0.5
    idx = np.arange(n_in)
    dist = (centers[:, None] - idx[None, :]) / support_scale
    w = _cubic(dist)
    w[np.abs(dist) >= 2] = 0.0  # zero outside the (scaled) support
    s = w.sum(axis=1, keepdims=True)
    return (w / np.maximum(s, 1e-8)).astype(np.float32)


def resize_bicubic_device(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """x (..., H, W, C) -> (..., H', W', C) fp32 via two matrix products."""
    h, w = x.shape[-3:-1]
    wh = torch.from_numpy(resize_matrix_bicubic(h, out_hw[0])).to(x.device)
    ww = torch.from_numpy(resize_matrix_bicubic(w, out_hw[1])).to(x.device)
    y = torch.einsum("oh,...hwc->...owc", wh, x.float())
    return torch.einsum("pw,...owc->...opc", ww, y)


def device_preprocess(images_u8: torch.Tensor, out_size: Optional[int] = None,
                      mean=CLIP_MEAN, std=CLIP_STD, out_dtype=torch.float32,
                      use_pallas: bool = False) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> normalized (B, S, S, 3): resize in float before
    normalising, like torchvision's Resize -> ToTensor -> Normalize.
    ``use_pallas`` (the JAX package's name) selects kernel B6 where no
    resize is asked for."""
    if use_pallas and out_size is None:
        return u8_normalize_rows(images_u8, mean, std, out_dtype)
    x = images_u8.float() / 255.0
    if out_size is not None and tuple(images_u8.shape[1:3]) != (out_size, out_size):
        x = resize_bicubic_device(x, (out_size, out_size))
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - m) / s).to(out_dtype)
