"""Host-side image transforms on HWC uint8 numpy arrays (counterpart of
``myriad_tpu/processors/functional.py``), equal to PIL's bytes.

The card has no PIL.  ``resize_bicubic`` redoes Pillow's ``Image.resize(...,
BICUBIC)`` (``libImaging/Resample.c``) in numpy: per output pixel a window of
input pixels weighted by the bicubic filter (a = -0.5, widened by the
downscale factor), the weights normalised in double and rounded to 22-bit
fixed point, integer sums rounded and clipped to 0-255, a horizontal pass
first and a vertical pass on its uint8 result.  Each pass sums the window's
taps in int32, as Resample.c does (255 times the weights' absolute sum stays
below 2^31), so the result is PIL's to the byte
(``ops/preprocess.resize_bicubic_device`` is only close to it).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple, Union

import numpy as np

# CLIP statistics, copied from myriad_tpu/processors/functional.py (which
# imports PIL); tests/test_torch_evaluate.py holds the copies equal.
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)

_PRECISION_BITS = 32 - 8 - 2  # Resample.c's fixed point for 8-bit images


def _bicubic(x: float) -> float:
    a = -0.5
    if x < 0.0:
        x = -x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


@functools.lru_cache(maxsize=64)
def _coefficients(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Resample.c's ``precompute_coeffs`` and ``normalize_coeffs_8bpc``: for
    each output pixel its window's first input index and length, and its
    fixed-point weights (out, ksize); taps past a window's end weigh 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    first = np.zeros(out_size, np.int64)
    count = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int32)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        total = 0.0
        for w in k:  # in order, as C sums (Python's sum() compensates)
            total += w
        for x, w in enumerate(k):
            w = w / total if total != 0.0 else w
            weights[xx, x] = int((-0.5 if w < 0 else 0.5) + w * (1 << _PRECISION_BITS))
        first[xx], count[xx] = xmin, xmax
    return first, count, weights


def _resample(src: np.ndarray, axis: int, in_size: int, out_size: int,
              offset: int = 0) -> np.ndarray:
    """One pass of Resample.c along ``axis`` (1: horizontal, 0: vertical) of
    (H, W, C) uint8 whose index 0 along ``axis`` is input pixel ``offset``."""
    first, _, weights = _coefficients(in_size, out_size)
    shape = [1, 1, 1]
    shape[axis] = -1
    acc = np.full(src.shape[:axis] + (out_size,) + src.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int32)
    last = src.shape[axis] - 1
    for k in range(weights.shape[1]):
        taps = np.minimum(first - offset + k, last)
        acc += np.take(src, taps, axis=axis) * weights[:, k].reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def pil_resize(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``Image.fromarray(img).resize((width, height), Image.BICUBIC)`` on
    (H, W, C) uint8, byte for byte."""
    img = np.asarray(img, np.uint8)
    in_h, in_w = img.shape[:2]
    if (width, height) == (in_w, in_h):
        return img.copy()
    lo, hi = 0, in_h
    if height != in_h:  # the horizontal pass runs over the rows the vertical one reads
        first, count, _ = _coefficients(in_h, height)
        lo, hi = int(first[0]), int(first[-1] + count[-1])
    out = img[lo:hi]
    if width != in_w:
        out = _resample(out, 1, in_w, width)
    if height != in_h:
        out = _resample(out, 0, in_h, height, offset=lo)
    return out


def resize_bicubic(img: np.ndarray, size: Union[int, Tuple[int, int]]) -> np.ndarray:
    """torchvision ``Resize(size, BICUBIC)`` semantics, as the JAX helper:
    an int scales the short edge to ``size`` keeping the aspect ratio (the
    long edge by Python's ``round``); (h, w) resizes exactly."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    if isinstance(size, int):
        short, long = (w, h) if w <= h else (h, w)
        if short == size:
            return img
        new_long = int(round(size * long / short))
        nw, nh = (size, new_long) if w <= h else (new_long, size)
        return pil_resize(img, nw, nh)
    nh, nw = size
    return pil_resize(img, nw, nh)


def center_crop(img: np.ndarray, size: Union[int, Tuple[int, int]]) -> np.ndarray:
    """torchvision ``CenterCrop`` semantics, as the JAX helper (black padding
    when the image is smaller, offsets by Python's ``round``)."""
    img = np.asarray(img, np.uint8)
    th, tw = (size, size) if isinstance(size, int) else size
    h, w = img.shape[:2]
    if w < tw or h < th:
        padded = np.zeros((max(h, th), max(w, tw)) + img.shape[2:], np.uint8)
        top, left = (max(h, th) - h) // 2, (max(w, tw) - w) // 2
        padded[top:top + h, left:left + w] = img
        img = padded
        h, w = img.shape[:2]
    left = int(round((w - tw) / 2.0))
    top = int(round((h - th) / 2.0))
    return img[top:top + th, left:left + tw]


def to_float_hwc(img: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 HWC in [0, 1] (torchvision ToTensor without the
    CHW permute)."""
    return np.asarray(img, dtype=np.float32) / 255.0


def normalize(arr: np.ndarray, mean: np.ndarray = CLIP_MEAN,
              std: np.ndarray = CLIP_STD) -> np.ndarray:
    return (arr - mean) / std
