"""The OpenCV calls of NSA synthesis, in numpy and scipy (the card has no cv2).

``datasets/nsa.py`` (the counterpart of ``myriad_tpu/datasets/nsa.py``) calls
three of OpenCV's functions on uint8 images; each is redone here from what
OpenCV computes:

* ``median_blur(img, k)``: ``cv2.medianBlur`` (a k x k median, the border
  replicated), equal to it to the byte;
* ``resize_linear(img, (w, h))``: ``cv2.resize`` with ``INTER_LINEAR`` on
  uint8, equal to it to the byte: the source coordinate of each output pixel
  in float32, its two weights rounded to 11-bit fixed point, a horizontal
  pass of integer sums and a vertical pass that shifts each sum right by 4,
  takes the high half of its product with the 11-bit weight and rounds the
  total by 2 bits, as OpenCV's ``VResizeLinear`` for uchar does; an image of
  the requested size is returned as a copy, as ``cv::resize`` does;
* ``seamless_clone(src, dst, mask, center, mode)``: ``cv2.seamlessClone``
  with ``NORMAL_CLONE`` or ``MIXED_CLONE``, the guided Poisson solve of
  OpenCV's photo module: the mask's bounding box of ``src`` is cloned into
  ``dst`` centred at ``center``; forward-difference gradients of both, the
  box's mask eroded three times by a 3x3 square (its edges too), the guidance field's backward
  differences as the Laplacian, the destination's one-pixel border as the
  boundary, a discrete sine transform solve in float64 (OpenCV's is float32)
  and the result truncated to uint8.  It is within a grey level or two of
  OpenCV's, not equal to it.  A box that leaves ``dst`` raises
  ``CloneError``, where OpenCV raises ``cv2.error``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import fft, ndimage

NORMAL_CLONE = 1  # cv2.NORMAL_CLONE
MIXED_CLONE = 2  # cv2.MIXED_CLONE
_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


class CloneError(ValueError):
    """``seamless_clone`` cannot place the patch (``cv2.error`` in OpenCV)."""


def median_blur(img: np.ndarray, ksize: int) -> np.ndarray:
    """``cv2.medianBlur`` of a 2-D uint8 image, odd ``ksize``."""
    if img.dtype != np.uint8 or img.ndim != 2 or ksize % 2 == 0:
        raise ValueError(f"median_blur takes a 2-D uint8 image and an odd size, got "
                         f"{img.dtype} {img.shape}, {ksize}")
    return ndimage.median_filter(img, size=ksize, mode="nearest")


def _linear_taps(n_in: int, n_out: int, clamp_fraction: bool):
    """OpenCV's two source indices and 11-bit weights of each output position.
    Past an edge OpenCV moves a column's tap onto the edge with weight 1
    (``clamp_fraction``), but keeps a row's two weights and clamps only its
    source rows."""
    scale = 1.0 / (n_out / n_in)  # cv::resize's inv_scale, inverted in double
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp_fraction:
        low = s < 0
        f[low], s[low] = 0.0, 0
        high = s >= n_in - 1
        f[high], s[high] = 0.0, n_in - 1
    w0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE)).astype(np.int32)
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int32)
    return np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1), w0, w1


def resize_linear(img: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (width, height))`` (``INTER_LINEAR``) of a uint8 image,
    (H, W) or (H, W, C)."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"resize_linear takes a uint8 (H, W[, C]) image, got "
                         f"{img.dtype} {img.shape}")
    w_out, h_out = int(dsize[0]), int(dsize[1])
    h_in, w_in = img.shape[:2]
    if w_out <= 0 or h_out <= 0:
        raise ValueError(f"resize_linear to {dsize}")
    if (h_out, w_out) == (h_in, w_in):
        return img.copy()
    if (w_in == 2 * w_out and h_in == 2 * h_out):
        # OpenCV takes its INTER_AREA path for an exact halving: each output
        # is the rounded mean of its 2 x 2 block
        blocks = img.astype(np.int32).reshape(h_out, 2, w_out, 2, *img.shape[2:])
        return ((blocks.sum(axis=(1, 3)) + 2) >> 2).astype(np.uint8)
    x0, x1, a0, a1 = _linear_taps(w_in, w_out, True)
    y0, y1, b0, b1 = _linear_taps(h_in, h_out, False)
    src = img.astype(np.int32)
    expand = (slice(None),) + (None,) * (img.ndim - 2)
    rows = src[:, x0] * a0[expand] + src[:, x1] * a1[expand]  # (H_in, W_out[, C])
    b0 = b0[(slice(None), None) + (None,) * (img.ndim - 2)]
    b1 = b1[(slice(None), None) + (None,) * (img.ndim - 2)]
    out = ((b0 * (rows[y0] >> 4)) >> 16) + ((b1 * (rows[y1] >> 4)) >> 16)
    return ((out + 2) >> 2).astype(np.uint8)


def _filter_reflect101(a: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.filter2D`` (correlation, anchor at the centre, BORDER_REFLECT_101)
    of a float (H, W, C) array with a small 2-D kernel."""
    kh, kw = kernel.shape
    py, px = kh // 2, kw // 2
    padded = np.pad(a, ((py, py), (px, px), (0, 0)), mode="reflect")
    out = np.zeros_like(a)
    h, w = a.shape[:2]
    for i in range(kh):
        for j in range(kw):
            if kernel[i, j]:
                out += kernel[i, j] * padded[i:i + h, j:j + w]
    return out


_GRAD_X = np.array([[0.0, -1.0, 1.0]])
_GRAD_Y = _GRAD_X.T
_LAP_X = np.array([[-1.0, 1.0, 0.0]])
_LAP_Y = _LAP_X.T
_LAPLACIAN = np.array([[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]])


def _poisson(dest: np.ndarray, lap: np.ndarray) -> np.ndarray:
    """OpenCV's ``poissonSolver`` and ``solve`` on one channel: the interior
    solves lap(u) = ``lap`` with ``dest``'s one-pixel border as the boundary;
    the border is ``dest``'s; values are truncated into 0-255."""
    h, w = dest.shape
    bound = dest.astype(np.float64).copy()
    bound[1:-1, 1:-1] = 0.0
    boundary = _filter_reflect101(bound[..., None], _LAPLACIAN)[..., 0]
    rhs = (lap - boundary)[1:-1, 1:-1]
    fx = 2.0 * np.cos(np.pi * np.arange(1, w - 1) / (w - 1))
    fy = 2.0 * np.cos(np.pi * np.arange(1, h - 1) / (h - 1))
    coef = fft.dstn(rhs, type=1) / (fx[None, :] + fy[:, None] - 4.0)
    inner = fft.idstn(coef, type=1)
    out = dest.copy()
    out[1:-1, 1:-1] = np.clip(inner, 0.0, 255.0).astype(np.uint8)  # truncation
    return out


def seamless_clone(src: np.ndarray, dst: np.ndarray, mask: np.ndarray,
                   center: Tuple[int, int], mode: int) -> np.ndarray:
    """``cv2.seamlessClone(src, dst, mask, center, mode)``: src and dst (H, W, 3)
    uint8 of one size as OpenCV requires here, mask (H, W) or (H, W, 1) uint8
    of src's size, center (x, y)."""
    if mode not in (NORMAL_CLONE, MIXED_CLONE):
        raise ValueError(f"seamless_clone mode {mode}: NORMAL_CLONE (1) or MIXED_CLONE (2)")
    if src.dtype != np.uint8 or dst.dtype != np.uint8 or src.ndim != 3 or dst.ndim != 3:
        raise ValueError("seamless_clone takes uint8 (H, W, 3) images")
    m = mask[..., 0] if mask.ndim == 3 else mask
    if m.shape != src.shape[:2]:
        raise CloneError(f"mask {mask.shape} does not match src {src.shape}")
    m = m.copy()
    m[0], m[-1], m[:, 0], m[:, -1] = 0, 0, 0, 0
    ys, xs = np.nonzero(m)
    out = dst.copy()
    if ys.size == 0:
        return out
    top, left = int(ys.min()), int(xs.min())
    rh, rw = int(ys.max()) - top + 1, int(xs.max()) - left + 1
    dx, dy = int(center[0]) - rw // 2, int(center[1]) - rh // 2
    if dx < 0 or dy < 0 or dx + rw > dst.shape[1] or dy + rh > dst.shape[0]:
        raise CloneError(f"the {rw}x{rh} patch centred at {tuple(center)} leaves the "
                         f"{dst.shape[1]}x{dst.shape[0]} destination")
    mroi = m[top:top + rh, left:left + rw]
    patch = np.where(mroi[..., None] > 0, src[top:top + rh, left:left + rw], 0)
    dest = dst[dy:dy + rh, dx:dx + rw]

    d = dest.astype(np.float64)
    p = patch.astype(np.float64)
    dgx, dgy = _filter_reflect101(d, _GRAD_X), _filter_reflect101(d, _GRAD_Y)
    pgx, pgy = _filter_reflect101(p, _GRAD_X), _filter_reflect101(p, _GRAD_Y)
    # erode(mask, 3x3, iterations=3) on the box, a view of the whole mask:
    # OpenCV reads the zeros around the box, so its edges erode too
    eroded = ndimage.grey_erosion(mroi, size=(7, 7), mode="constant", cval=0)
    inside = (eroded.astype(np.float64) / 255.0)[..., None]
    outside = ((255 - eroded).astype(np.float64) / 255.0)[..., None]
    if mode == NORMAL_CLONE:
        pgx, pgy = pgx * inside, pgy * inside
    else:
        take = np.abs(pgx - pgy) > np.abs(dgx - dgy)
        pgx = np.where(take, pgx, dgx) * inside
        pgy = np.where(take, pgy, dgy) * inside
    lap = (_filter_reflect101(dgx * outside + pgx, _LAP_X)
           + _filter_reflect101(dgy * outside + pgy, _LAP_Y))
    for c in range(3):
        out[dy:dy + rh, dx:dx + rw, c] = _poisson(dest[..., c], lap[..., c])
    return out
