"""The processors of the training configs (counterpart of
``myriad_tpu/processors/blip_processors.py``).

``BlipCaptionProcessor`` lowercases, strips punctuation and truncates a
caption.  ``blip2_image_train`` / ``blip2_image_eval`` resize an image to a
square with PIL's BICUBIC and normalise it with the CLIP statistics to
float32 HWC; ``raw_image`` only resizes (and centre-crops a dict sample),
uint8 out.  ``LocImageTrainProcessor`` normalises {'img', 'gt_seg_map'}
samples; with ``identity: False`` it first crops: ``strong_aug`` a random
half-size crop resized back with BILINEAR (the mask NEAREST), else the short
edge resized to ``image_size`` with BILINEAR (the mask NEAREST) and a random
square crop, every offset drawn from its generator in the JAX processor's
order.  Images are uint8 HWC arrays (the JAX processors take PIL images or
arrays; every resize here is PIL's to the byte, ``processors/functional``).
``build_processor`` builds one from its config node.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np

from myriad_tpu_torch.processors import functional as F


class BaseProcessor:
    def __call__(self, item):
        return item

    @classmethod
    def from_config(cls, cfg=None):
        return cls()


class BlipCaptionProcessor(BaseProcessor):
    def __init__(self, prompt: str = "", max_words: int = 50):
        self.prompt = prompt
        self.max_words = max_words

    def __call__(self, caption: str) -> str:
        return self.prompt + self.pre_caption(caption)

    def pre_caption(self, caption: str) -> str:
        caption = re.sub(r"([.!\"()*#:;~])", " ", caption.lower())
        caption = re.sub(r"\s{2,}", " ", caption)
        caption = caption.rstrip("\n").strip(" ")
        words = caption.split(" ")
        if len(words) > self.max_words:
            caption = " ".join(words[: self.max_words])
        return caption

    @classmethod
    def from_config(cls, cfg=None):
        cfg = cfg or {}
        return cls(prompt=cfg.get("prompt", ""), max_words=cfg.get("max_words", 50))


class BlipImageBaseProcessor(BaseProcessor):
    """The CLIP normalisation (``mean``/``std`` overridable)."""

    def __init__(self, mean=None, std=None):
        self.mean = np.asarray(mean, np.float32) if mean is not None else F.CLIP_MEAN
        self.std = np.asarray(std, np.float32) if std is not None else F.CLIP_STD

    def normalize(self, arr: np.ndarray) -> np.ndarray:
        return F.normalize(arr, self.mean, self.std)


class Blip2ImageTrainProcessor(BlipImageBaseProcessor):
    """BICUBIC resize to (image_size, image_size), [0, 1], normalise."""

    def __init__(self, image_size: int = 224, mean=None, std=None, **_unused):
        super().__init__(mean, std)
        self.image_size = image_size

    def __call__(self, item) -> np.ndarray:
        img = F.resize_bicubic(F.to_uint8(item), (self.image_size, self.image_size))
        return self.normalize(F.to_float_hwc(img))

    @classmethod
    def from_config(cls, cfg=None):
        cfg = cfg or {}
        return cls(image_size=cfg.get("image_size", 224), mean=cfg.get("mean"),
                   std=cfg.get("std"))


class Blip2ImageEvalProcessor(Blip2ImageTrainProcessor):
    """The same pipeline at evaluation."""


class LocImageTrainProcessor(BlipImageBaseProcessor):
    def __init__(self, image_size: int = 224, mean=None, std=None, strong_aug: bool = False,
                 identity: bool = False, seed: Optional[int] = None, **_unused):
        super().__init__(mean, std)
        self.image_size = image_size
        self.strong_aug = strong_aug
        self.identity = identity
        self.rng = np.random.default_rng(seed)

    def _geometric(self, img: np.ndarray, seg: Optional[np.ndarray]):
        size = self.image_size
        if self.identity:
            return img, seg
        stacked = img if seg is None else np.concatenate(
            [img, seg[..., None].astype(img.dtype)], -1)
        if self.strong_aug:  # RandomCrop(relative 0.5 x 0.5), then Resize(size, size)
            h, w = stacked.shape[:2]
            stacked = F.random_crop(stacked, (max(1, int(h * 0.5)), max(1, int(w * 0.5))),
                                    self.rng)
        else:  # ResizeShortestEdge(size), then RandomCrop(size, size)
            img_r = F.resize_shortest_edge(F.to_uint8(stacked[..., :3]), size)
            if seg is not None:
                seg_r = F.resize_nearest(F.to_uint8(stacked[..., 3]), img_r.shape[1],
                                         img_r.shape[0])
                stacked = np.concatenate([img_r, seg_r[..., None]], -1)
            else:
                stacked = img_r
            stacked = F.random_crop(stacked, (size, size), self.rng)
        img_out = stacked[..., :3]
        seg_out = stacked[..., 3] if seg is not None else None
        if self.strong_aug:
            img_out = F.pil_resize(F.to_uint8(img_out), size, size, "bilinear")
            if seg_out is not None:
                seg_out = F.resize_nearest(F.to_uint8(seg_out), size, size)
        return img_out, seg_out

    def __call__(self, data_sample: dict) -> dict:
        ret = dict(data_sample)
        img = np.asarray(ret["img"])
        seg = ret.get("gt_seg_map")
        seg = None if seg is None else np.asarray(seg)
        img, seg = self._geometric(img, seg)
        ret["img"] = self.normalize(np.asarray(img, np.float32) / 255.0)
        if seg is not None:
            ret["gt_seg_map"] = seg
        return ret

    @classmethod
    def from_config(cls, cfg=None):
        cfg = cfg or {}
        return cls(image_size=cfg.get("image_size", 224), mean=cfg.get("mean"),
                   std=cfg.get("std"), strong_aug=cfg.get("strong_aug", False),
                   identity=cfg.get("identity", False))


class RawImageProcessor(BaseProcessor):
    """Geometry only, uint8 out (the CLIP normalisation runs on the device):
    a dict sample's ``img`` BICUBIC-resized on its short edge to
    ``image_size`` and centre-cropped to ``crop_size``; an image resized to
    (image_size, image_size)."""

    def __init__(self, image_size: int = 224, crop_size: Optional[int] = None, **_unused):
        self.image_size = image_size
        self.crop_size = crop_size or image_size

    def __call__(self, item) -> np.ndarray:
        if isinstance(item, dict):
            out = dict(item)
            img = F.to_uint8(item["img"])
            out["img"] = F.center_crop(F.resize_bicubic(img, self.image_size), self.crop_size)
            return out
        return F.resize_bicubic(F.to_uint8(item), (self.image_size, self.image_size))

    @classmethod
    def from_config(cls, cfg=None):
        cfg = cfg or {}
        return cls(image_size=cfg.get("image_size", 224), crop_size=cfg.get("crop_size"))


PROCESSORS = {"blip_caption": BlipCaptionProcessor, "loc_image_train": LocImageTrainProcessor,
              "blip2_image_train": Blip2ImageTrainProcessor,
              "blip2_image_eval": Blip2ImageEvalProcessor, "raw_image": RawImageProcessor}


def build_processor(cfg) -> BaseProcessor:
    """The processor a config node names (``name``), or the identity."""
    if cfg is None or cfg.get("name") is None:
        return BaseProcessor()
    try:
        cls = PROCESSORS[cfg["name"]]
    except KeyError:
        raise NotImplementedError(f"processor {cfg['name']!r} is not ported; the port has "
                                  f"{', '.join(sorted(PROCESSORS))}") from None
    return cls.from_config(cfg)
