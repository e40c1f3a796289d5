"""Host-side image transforms on HWC uint8 numpy arrays (counterpart of
``myriad_tpu/processors/functional.py``), equal to PIL's bytes.

The card has no PIL.  ``pil_resize`` redoes Pillow's ``Image.resize`` with
BICUBIC or BILINEAR (``libImaging/Resample.c``) in numpy: per output pixel a
window of input pixels weighted by the filter (bicubic with a = -0.5 over
two pixels, or the triangle over one, widened by the downscale factor), the
weights normalised in double and rounded to 22-bit fixed point, integer
sums rounded and clipped to 0-255, a horizontal pass first and a vertical
pass on its uint8 result.  Each pass sums the window's taps in int32, as
Resample.c does (255 times the weights' absolute sum stays below 2^31), so
the result is PIL's to the byte (``ops/preprocess.resize_bicubic_device`` is
only close to it).  ``resize_nearest`` is Pillow's NEAREST resize, an affine
scale (``libImaging/Geometry.c``) whose source positions accumulate in
double as Pillow accumulates them.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple, Union

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


def _bilinear(x: float) -> float:
    if x < 0.0:
        x = -x
    if x < 1.0:
        return 1.0 - x
    return 0.0


# Resample.c's filters: (function, support)
FILTERS = {"bicubic": (_bicubic, 2.0), "bilinear": (_bilinear, 1.0)}


@functools.lru_cache(maxsize=64)
def _coefficients(in_size: int, out_size: int,
                  kind: str = "bicubic") -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Resample.c's ``precompute_coeffs`` and ``normalize_coeffs_8bpc``: for
    each output pixel its window's first input index and length, and its
    fixed-point weights (out, ksize); taps past a window's end weigh 0."""
    filt, filter_support = FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    first = np.zeros(out_size, np.int64)
    count = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int32)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [filt((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        total = 0.0
        for w in k:  # in order, as C sums (Python's sum() compensates)
            total += w
        for x, w in enumerate(k):
            w = w / total if total != 0.0 else w
            weights[xx, x] = int((-0.5 if w < 0 else 0.5) + w * (1 << _PRECISION_BITS))
        first[xx], count[xx] = xmin, xmax
    return first, count, weights


def _resample(src: np.ndarray, axis: int, in_size: int, out_size: int,
              offset: int = 0, kind: str = "bicubic") -> np.ndarray:
    """One pass of Resample.c along ``axis`` (1: horizontal, 0: vertical) of
    (H, W, C) uint8 whose index 0 along ``axis`` is input pixel ``offset``."""
    first, _, weights = _coefficients(in_size, out_size, kind)
    shape = [1, 1, 1]
    shape[axis] = -1
    acc = np.full(src.shape[:axis] + (out_size,) + src.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int32)
    last = src.shape[axis] - 1
    for k in range(weights.shape[1]):
        taps = np.minimum(first - offset + k, last)
        acc += np.take(src, taps, axis=axis) * weights[:, k].reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def pil_resize(img: np.ndarray, width: int, height: int, kind: str = "bicubic") -> np.ndarray:
    """``Image.fromarray(img).resize((width, height), Image.BICUBIC)`` (or
    ``BILINEAR`` for ``kind="bilinear"``) on (H, W, C) or (H, W) uint8, byte
    for byte."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        return pil_resize(img[..., None], width, height, kind)[..., 0]
    in_h, in_w = img.shape[:2]
    if (width, height) == (in_w, in_h):
        return img.copy()
    lo, hi = 0, in_h
    if height != in_h:  # the horizontal pass runs over the rows the vertical one reads
        first, count, _ = _coefficients(in_h, height, kind)
        lo, hi = int(first[0]), int(first[-1] + count[-1])
    out = img[lo:hi]
    if width != in_w:
        out = _resample(out, 1, in_w, width, kind=kind)
    if height != in_h:
        out = _resample(out, 0, in_h, height, offset=lo, kind=kind)
    return out


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Geometry.c's ``ImagingScaleAffine`` positions: x0 = step / 2, then
    += step per pixel, in double; -1 where the position falls outside."""
    step = in_size / out_size
    idx = np.empty(out_size, np.int64)
    pos = 0.0 + step * 0.5
    for x in range(out_size):
        i = -1 if pos < 0.0 else int(pos)
        idx[x] = i if 0 <= i < in_size else -1
        pos += step
    return idx


def resize_nearest(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``Image.fromarray(img).resize((width, height), Image.NEAREST)`` on
    (H, W[, C]) uint8, byte for byte (positions outside the input are 0)."""
    img = np.asarray(img, np.uint8)
    in_h, in_w = img.shape[:2]
    if (width, height) == (in_w, in_h):
        return img.copy()
    xi, yi = _nearest_index(in_w, width), _nearest_index(in_h, height)
    out = img[np.maximum(yi, 0)][:, np.maximum(xi, 0)]
    out[yi < 0] = 0
    out[:, xi < 0] = 0
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


def resize_shortest_edge(img: np.ndarray, size: int, max_size: Optional[int] = None) -> np.ndarray:
    """mmdet ``ResizeShortestEdge`` as the JAX helper does it: the short edge
    to ``size`` (the scale capped by ``max_size`` over the long edge), sides
    rounded by Python's ``round``, PIL's BILINEAR."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    scale = size / min(w, h)
    if max_size is not None:
        scale = min(scale, max_size / max(w, h))
    return pil_resize(img, int(round(w * scale)), int(round(h * scale)), "bilinear")


def random_crop(img: np.ndarray, crop: Tuple[int, int],
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """A random (th, tw) crop of an HWC array, zero-padded below and to the
    right when smaller; ``rng`` draws the top, then the left offset."""
    rng = rng or np.random.default_rng()
    th, tw = crop
    h, w = img.shape[:2]
    if h < th or w < tw:
        pad_h, pad_w = max(0, th - h), max(0, tw - w)
        img = np.pad(img, ((0, pad_h), (0, pad_w)) + ((0, 0),) * (img.ndim - 2))
        h, w = img.shape[:2]
    top = int(rng.integers(0, h - th + 1))
    left = int(rng.integers(0, w - tw + 1))
    return img[top:top + th, left:left + tw]


def expand2square(img: np.ndarray, background: Tuple[int, int, int] = (0, 0, 0)) -> np.ndarray:
    """Pad an RGB uint8 image to a square of ``background``, centred as
    PIL's paste at ((side - w) // 2, (side - h) // 2)."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    if w == h:
        return img
    side = max(w, h)
    out = np.empty((side, side, 3), np.uint8)
    out[:] = np.asarray(background, np.uint8)
    top, left = (side - h) // 2, (side - w) // 2
    out[top:top + h, left:left + w] = img
    return out


def to_uint8(img) -> np.ndarray:
    """An array as the JAX helper's ``to_pil`` takes it: uint8 as is, any
    other dtype clipped to 0-255 and truncated."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    return arr
