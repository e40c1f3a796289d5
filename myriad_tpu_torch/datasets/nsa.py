"""NSA synthetic anomalies (counterpart of ``myriad_tpu/datasets/nsa.py``).

``patch_ex`` pastes and blends random patches of a source image into a
destination image and returns the blended image, a pixel label map and the
patch boxes, as the JAX package's does: the same numpy draws in the same
order, so one generator state gives the same geometry, boxes and patch masks
and leaves the generator in the same state.  Its OpenCV calls are the port's
own (``datasets/cv_ops.py``: median blur and bilinear resize equal to
OpenCV's, Poisson blending within a grey level or two of it), since the card
has no cv2.  It runs on the host, in the loader's threads.

Modes 'uniform', 'swap', 'mix', NORMAL_CLONE and MIXED_CLONE; label modes
'binary', 'continuous', 'intensity' and 'logistic-intensity'.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
from scipy import ndimage

from myriad_tpu_torch.datasets.cv_ops import (MIXED_CLONE, NORMAL_CLONE, CloneError,
                                              median_blur, resize_linear, seamless_clone)

Mode = Union[str, int]

_CLONE_MODES = (NORMAL_CLONE, MIXED_CLONE)


def _disk_footprint(radius: int) -> np.ndarray:
    y, x = np.ogrid[-radius : radius + 1, -radius : radius + 1]
    return (x * x + y * y) <= radius * radius


def _median_disk(img: np.ndarray, radius: int = 5) -> np.ndarray:
    """skimage.filters.median(img, disk(radius)) equivalent."""
    return ndimage.median_filter(img, footprint=_disk_footprint(radius), mode="nearest")


def _object_mask(img: np.ndarray, skip_background) -> np.ndarray:
    """1 where the pixel differs enough from every background color."""
    if isinstance(skip_background, tuple):
        skip_background = [skip_background]
    mask = np.ones_like(img[..., 0:1], np.uint8)
    for background, threshold in skip_background:
        mask &= np.uint8(
            np.abs(img.mean(axis=-1, keepdims=True) - background) > threshold
        )
    mask[..., 0] = median_blur(mask[..., 0], 7)
    return mask


@dataclasses.dataclass
class PatchExConfig:
    mode: Mode = NORMAL_CLONE
    num_patches: int = 1
    width_bounds_pct: Tuple[Tuple[float, float], Tuple[float, float]] = (
        (0.05, 0.2),
        (0.05, 0.2),
    )
    min_object_pct: float = 0.25
    min_overlap_pct: float = 0.25
    shift: bool = True
    resize: bool = True
    same: bool = False
    label_mode: str = "binary"
    skip_background: Optional[Sequence] = None
    tol: int = 1
    gamma_params: Optional[Tuple[float, float, float]] = None
    intensity_logistic_params: Tuple[float, float] = (1 / 6, 20)
    resize_bounds: Tuple[float, float] = (0.7, 1.3)
    num_ellipses: Optional[int] = None
    cutpaste_patch_generation: bool = False
    verbose: bool = False


def patch_ex(
    ima_dest: np.ndarray,
    ima_src: Optional[np.ndarray] = None,
    rng: Optional[np.random.Generator] = None,
    **kwargs,
) -> Tuple[np.ndarray, np.ndarray, List[List[int]]]:
    """Create one synthetic training example.

    Returns (augmented image, label map (H,W,1) float, boxes
    [x_min, y_min, x_max, y_max]).  Matches the reference's return triple
    (self_sup_tasks.py:115 — the third value is the box list, which the
    dataset's position text reads by its [0]/[1] corner entries).
    """
    cfg = PatchExConfig(**kwargs)
    rng = rng or np.random.default_rng()

    mode = cfg.mode
    if mode == "mix":
        mode = _CLONE_MODES[int(rng.integers(0, 2))]

    if cfg.cutpaste_patch_generation:
        cfg = dataclasses.replace(
            cfg, skip_background=None, resize=False, gamma_params=None, num_patches=1
        )

    ima_src = ima_dest.copy() if cfg.same or ima_src is None else ima_src

    src_mask = dest_mask = None
    if cfg.skip_background is not None and not cfg.cutpaste_patch_generation:
        src_mask = _object_mask(ima_src, cfg.skip_background)
        dest_mask = _object_mask(ima_dest, cfg.skip_background)

    boxes: List[List[int]] = []
    mask = np.zeros_like(ima_dest[..., 0:1])
    patchex = ima_dest.copy()
    cmin1, cmax1 = mask.shape[0] - 1, 0
    cmin2, cmax2 = mask.shape[1] - 1, 0
    factor = float(rng.uniform(0.05, 0.95)) if cfg.label_mode == "continuous" else 1.0

    for i in range(cfg.num_patches):
        if i == 0 or rng.integers(0, 2) > 0:
            patchex, coords, patch_mask = _paste_one(
                patchex, ima_src, dest_mask, src_mask, mode, cfg, factor, rng
            )
            if patch_mask is not None:
                (a1, b1), (a2, b2) = coords
                mask[a1:b1, a2:b2] = patch_mask
                cmin1, cmax1 = min(cmin1, a1), max(cmax1, b1)
                cmin2, cmax2 = min(cmin2, a2), max(cmax2, b2)
                boxes.append([cmin2, cmin1, cmax2, cmax1])

    # label construction (self_sup_tasks.py:98-113)
    label_mask = np.uint8(
        np.mean(np.abs(1.0 * mask * ima_dest - 1.0 * mask * patchex), axis=-1,
                keepdims=True) > cfg.tol
    )
    label_mask[..., 0] = median_blur(label_mask[..., 0], 5)

    if cfg.label_mode == "continuous":
        label = label_mask * factor
    elif cfg.label_mode in ("intensity", "logistic-intensity"):
        k, x0 = cfg.intensity_logistic_params
        label = np.mean(
            np.abs(label_mask * ima_dest * 1.0 - label_mask * patchex * 1.0),
            axis=-1, keepdims=True,
        )
        label[..., 0] = _median_disk(label[..., 0], 5)
        if cfg.label_mode == "logistic-intensity":
            label = label_mask / (1 + np.exp(-k * (label - x0)))
    elif cfg.label_mode == "binary":
        label = label_mask
    else:
        raise ValueError(f"label_mode not supported: {cfg.label_mode}")

    return patchex, label, boxes


def _sample_patch_geometry(dims, cfg: PatchExConfig, rng):
    """Half-width sampling (uniform within bounds or offset gamma)."""
    min_w1 = int(round(cfg.width_bounds_pct[0][0] * dims[0]))
    max_w1 = int(round(cfg.width_bounds_pct[0][1] * dims[0]))
    min_w2 = int(round(cfg.width_bounds_pct[1][0] * dims[1]))
    max_w2 = int(round(cfg.width_bounds_pct[1][1] * dims[1]))
    if cfg.gamma_params is not None:
        shape, scale, lower = cfg.gamma_params
        w1 = int(np.clip((lower + rng.gamma(shape, scale)) * dims[0], min_w1, max_w1))
        w2 = int(np.clip((lower + rng.gamma(shape, scale)) * dims[1], min_w2, max_w2))
    else:
        w1 = int(rng.integers(min_w1, max_w1))
        w2 = int(rng.integers(min_w2, max_w2))
    return (min_w1, max_w1, min_w2, max_w2), (w1, w2)


def _paste_one(ima_dest, ima_src, dest_mask, src_mask, mode, cfg: PatchExConfig,
               factor, rng):
    """Sample one patch, optionally resize/shift, blend. Returns
    (image, ((min1,max1),(min2,max2)), patch_mask or None)."""
    dims = np.array(ima_dest.shape)
    fail = (ima_dest.copy(), ((0, 0), (0, 0)), None)

    if cfg.cutpaste_patch_generation:
        if dims[0] != dims[1]:
            raise ValueError("CutPaste patch generation needs square images")
        area_ratio = rng.uniform(0.02, 0.15) / 4.0
        aspect = rng.uniform(0.3, 1) if rng.integers(0, 2) > 0 else rng.uniform(1, 3.3)
        w1 = int(np.rint(np.clip(np.sqrt(area_ratio * aspect * dims[0] ** 2), 0, dims[0])))
        w2 = int(np.rint(np.clip(area_ratio * dims[0] ** 2 / w1, 0, dims[1])))
        c1 = int(rng.integers(w1, dims[0] - w1))
        c2 = int(rng.integers(w2, dims[1] - w2))
        min1, max1 = np.clip(c1 - w1, 0, dims[0]), np.clip(c1 + w1, 0, dims[0])
        min2, max2 = np.clip(c2 - w2, 0, dims[1]), np.clip(c2 + w2, 0, dims[1])
        patch_mask = np.ones((max1 - min1, max2 - min2, 1), np.uint8)
        bounds = (1, dims[0] - 1, 1, dims[1] - 1)
    else:
        skip_bg = src_mask is not None and dest_mask is not None
        bounds, (w1, w2) = _sample_patch_geometry(dims, cfg, rng)
        min_w1, max_w1, min_w2, max_w2 = bounds
        found = False
        for _ in range(200):
            c1 = int(rng.integers(min_w1, dims[0] - min_w1))
            c2 = int(rng.integers(min_w2, dims[1] - min_w2))
            min1 = int(np.clip(c1 - w1, 0, dims[0]))
            min2 = int(np.clip(c2 - w2, 0, dims[1]))
            max1 = int(np.clip(c1 + w1, 0, dims[0]))
            max2 = int(np.clip(c2 + w2, 0, dims[1]))
            if cfg.num_ellipses is not None:
                patch_mask = _ellipse_mask(
                    (max1 - min1, max2 - min2), (min_w1, max(min_w1 + 1, w1 // 2)),
                    (min_w2, max(min_w2 + 1, w2 // 2)), cfg.num_ellipses, rng,
                )
            else:
                patch_mask = np.ones((max1 - min1, max2 - min2, 1), np.uint8)
            if skip_bg:
                bg_area = np.sum(patch_mask & src_mask[min1:max1, min2:max2])
                area = (np.sum(patch_mask) if cfg.num_ellipses is not None
                        else patch_mask.shape[0] * patch_mask.shape[1])
                found = bg_area / max(area, 1) > cfg.min_object_pct
            else:
                found = True
            if found:
                break
        if not found:
            return fail

    src = ima_src[min1:max1, min2:max2]
    height, width = src.shape[:2]

    if cfg.resize and not cfg.cutpaste_patch_generation:
        min_w1, max_w1, min_w2, max_w2 = bounds
        lb, ub = cfg.resize_bounds
        scale = float(np.clip(rng.normal(1, 0.5), lb, ub))
        new_h = int(np.clip(scale * height, min_w1, max_w1))
        new_w = int(np.clip(int(new_h / height * width), min_w2, max_w2))
        new_h = int(np.clip(int(new_w / width * height), min_w1, max_w1))
        if src.shape[2] == 1:
            src = resize_linear(src[..., 0], (new_w, new_h))[..., None]
        else:
            src = resize_linear(src, (new_w, new_h))
        height, width = src.shape[:2]
        patch_mask = resize_linear(patch_mask[..., 0], (width, height))[..., None]

    skip_bg = src_mask is not None and dest_mask is not None
    local_src_mask = None
    if skip_bg:
        local_src_mask = resize_linear(
            src_mask[min1:max1, min2:max2, 0], (width, height)
        )[..., None]

    if cfg.shift:
        found = False
        for _ in range(200):
            c1 = int(rng.integers(height // 2 + 1, ima_dest.shape[0] - height // 2 - 1))
            c2 = int(rng.integers(width // 2 + 1, ima_dest.shape[1] - width // 2 - 1))
            min1, max1 = c1 - height // 2, c1 + (height + 1) // 2
            min2, max2 = c2 - width // 2, c2 + (width + 1) // 2
            if skip_bg:
                dm = dest_mask[min1:max1, min2:max2]
                both = dm & local_src_mask & patch_mask
                found = (
                    np.sum(local_src_mask) / (patch_mask.shape[0] * patch_mask.shape[1])
                    > cfg.min_object_pct
                    and np.sum(both) / max(np.sum(local_src_mask), 1) > cfg.min_overlap_pct
                )
            else:
                found = True
            if found:
                break
        if not found:
            return fail

    if skip_bg:
        patch_mask = patch_mask & (
            local_src_mask | dest_mask[min1:max1, min2:max2]
        )

    # blend
    if mode == "swap":
        out = ima_dest.copy()
        before = out[min1:max1, min2:max2]
        out[min1:max1, min2:max2] = before - patch_mask * before + patch_mask * src
    elif mode == "uniform":
        out = 1.0 * ima_dest
        before = out[min1:max1, min2:max2]
        out[min1:max1, min2:max2] = (
            before - factor * patch_mask * before + factor * patch_mask * src
        )
        out = np.uint8(np.floor(out))
    elif mode in _CLONE_MODES:
        int_factor = np.uint8(np.ceil(factor * 255))
        if skip_bg:
            scaled = int_factor * (
                patch_mask
                | ((1 - local_src_mask) & (1 - dest_mask[min1:max1, min2:max2]))
            )
        else:
            scaled = int_factor * patch_mask
        scaled[0], scaled[-1], scaled[:, 0], scaled[:, -1] = 0, 0, 0, 0
        center = (max2 - (max2 - min2) // 2, min1 + (max1 - min1) // 2)
        if np.sum(scaled > 0) < 50:  # seamlessClone fails on tiny masks
            return fail
        try:
            if ima_dest.shape[2] == 1:
                src3 = np.concatenate([src, np.zeros_like(src), np.zeros_like(src)], 2)
                dest3 = np.concatenate(
                    [ima_dest, np.zeros_like(ima_dest), np.zeros_like(ima_dest)], 2
                )
                out = seamless_clone(src3, dest3, scaled, center, mode)[..., 0:1]
            else:
                out = seamless_clone(src, ima_dest, scaled, center, mode)
        except CloneError as e:
            if cfg.verbose:
                print("WARNING, bad interpolation mask:", e)
            return fail
    else:
        raise ValueError(f"mode not supported: {mode}")

    return out, ((min1, max1), (min2, max2)), patch_mask


def _ellipse_mask(shape, w1_range, w2_range, num_ellipses: int, rng) -> np.ndarray:
    mask = np.zeros(shape, np.uint8)
    x = np.arange(shape[0]).reshape(-1, 1)
    y = np.arange(shape[1]).reshape(1, -1)
    for _ in range(num_ellipses):
        theta = rng.uniform(0, np.pi)
        x0 = int(rng.integers(0, shape[0]))
        y0 = int(rng.integers(0, shape[1]))
        a = int(rng.integers(*w1_range))
        b = int(rng.integers(*w2_range))
        ellipse = (
            (((x - x0) * np.cos(theta) + (y - y0) * np.sin(theta)) / a) ** 2
            + (((x - x0) * np.sin(theta) + (y - y0) * np.cos(theta)) / b) ** 2
        ) <= 1
        mask |= ellipse
    return mask[..., None]
