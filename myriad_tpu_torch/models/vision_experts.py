"""The vision-expert mux (counterpart of ``myriad_tpu/models/vision_experts.py``):
the interchangeable frozen anomaly experts by name.

* ``patchcore`` / ``adrefexpert``: the ImageBind expert of zero- and one-shot
  maps (``models/vision_expert.py``), the Myriad default;
* ``adgpt``: its zero-shot maps only;
* ``simplenet`` / ``simplenetV``: the per-class discriminator expert
  (``models/simplenet.py``), its input renormalised to ImageNet statistics;
* ``aprilgan``: precomputed mask PNGs under ``ve_root``, read as
  ``cv2.imread(path, IMREAD_GRAYSCALE)`` and ``cv2.resize`` read them
  (``datasets/png.py``, ``datasets/cv_ops.py``).

Each takes the pipeline's CLIP-normalised images (B, H, W, 3) and the
classes, and gives (maps (B, 224, 224, 1), masks (B, 16, 16, 1)) on its
device.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from myriad_tpu_torch.datasets.cv_ops import resize_linear
from myriad_tpu_torch.datasets.png import read_png_gray
from myriad_tpu_torch.ops.preprocess import u8_normalize
from myriad_tpu_torch.processors.functional import CLIP_MEAN, CLIP_STD


def renormalize(images: torch.Tensor, from_mean=CLIP_MEAN, from_std=CLIP_STD,
                to_mean=CLIP_MEAN, to_std=CLIP_STD) -> torch.Tensor:
    """Convert normalised images between normalisation conventions."""
    def t(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=images.device)

    return (images * t(from_std) + t(from_mean) - t(to_mean)) / t(to_std)


def read_mask(path: str, size: int) -> np.ndarray:
    """A mask PNG as ``cv2.resize(cv2.imread(path, IMREAD_GRAYSCALE), (size,
    size)) / 255`` in float32, or zeros when the file is missing."""
    if not os.path.isfile(path):
        return np.zeros((size, size), np.float32)
    return resize_linear(read_png_gray(path), (size, size)).astype(np.float32) / 255.0


class ZeroShotExpert:
    """'adgpt': zero-shot maps only."""

    def __init__(self, inner):
        self.inner = inner  # a VisionExpert

    def __call__(self, images, cls_names, querypath=None, testphase=False):
        return self.inner(images, cls_names, one_shot=False)


class PrecomputedMaskExpert:
    """Anomaly maps from precomputed mask files under ``ve_root``: the file
    of an image ``a/b.jpg`` is ``ve_root/a/b.png``; a missing one gives a
    zero map."""

    def __init__(self, ve_root: str, map_size: int = 224, *, device="cuda"):
        self.ve_root = ve_root
        self.map_size = map_size
        self.device = torch.device(device)

    def __call__(self, img_paths: Sequence[str], cls_names=None):
        maps = np.stack([read_mask(os.path.join(self.ve_root, os.path.splitext(p)[0] + ".png"),
                                   self.map_size)[..., None] for p in img_paths])
        step = self.map_size // 16
        maps = torch.from_numpy(maps).to(self.device)
        return maps, maps[:, ::step, ::step]


class SimpleNetExpertAdapter:
    """``SimpleNetInterface`` as an expert: CLIP-normalised input renormalised
    to ImageNet statistics; the maps as the interface gives them (score + 1).
    uint8 input is first normalised with the CLIP statistics, as the towers
    take it (the JAX adapter renormalises uint8 as if it were that float: a
    deviation kept on purpose, ROADMAP C)."""

    def __init__(self, interface, map_size: int = 224):
        from myriad_tpu_torch.models.simplenet import IMAGENET_MEAN, IMAGENET_STD

        self.interface = interface
        self.map_size = map_size
        self._to_mean, self._to_std = IMAGENET_MEAN, IMAGENET_STD

    def __call__(self, images, cls_names, querypath=None, testphase=False):
        if images.dtype == torch.uint8:
            images = u8_normalize(images, out_dtype=torch.float32)
        x = renormalize(images.float(), to_mean=self._to_mean, to_std=self._to_std)
        _, maps = self.interface(x, list(cls_names))
        maps = torch.from_numpy(np.ascontiguousarray(maps, np.float32)).to(images.device)
        step = max(self.map_size // 16, 1)
        return maps, maps[:, ::step, ::step]


def build_vision_expert(name: str, *, device: Optional[torch.device] = None, **kwargs):
    """The expert named ``name`` (case-insensitive) from ``kwargs``:
    ``adrefexpert`` (the ImageBind ``VisionExpert``), ``simplenet_interface``
    or ``ve_root``; an unknown name raises ``KeyError``."""
    name = name.lower()
    if name in ("patchcore", "adrefexpert"):
        return kwargs["adrefexpert"]
    if name == "adgpt":
        return ZeroShotExpert(kwargs["adrefexpert"])
    if name in ("simplenet", "simplenetv"):
        return SimpleNetExpertAdapter(kwargs["simplenet_interface"])
    if name == "aprilgan":
        return PrecomputedMaskExpert(kwargs["ve_root"], device=device or "cuda")
    raise KeyError(f"unknown vision expert '{name}'")
