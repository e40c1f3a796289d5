"""The processors of the training configs (counterpart of
``myriad_tpu/processors/blip_processors.py``).

``BlipCaptionProcessor`` lowercases, strips punctuation and truncates a
caption.  ``LocImageTrainProcessor`` normalises {'img', 'gt_seg_map'} samples
with the CLIP statistics to float32 HWC; the repository's configs use it with
``identity: True``.  Its geometric modes (resize to the shortest edge and a
random crop, or the strong crop) resize with PIL in the JAX package; they are
not ported and raise.  ``build_processor`` builds one from its config node.
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


class LocImageTrainProcessor(BaseProcessor):
    def __init__(self, image_size: int = 224, mean=None, std=None, strong_aug: bool = False,
                 identity: bool = False, seed: Optional[int] = None, **_unused):
        if not identity:
            raise NotImplementedError(
                f"loc_image_train with identity=False (strong_aug={strong_aug}): its "
                "geometric modes resize with PIL and are not ported")
        self.mean = np.asarray(mean, np.float32) if mean is not None else F.CLIP_MEAN
        self.std = np.asarray(std, np.float32) if std is not None else F.CLIP_STD
        self.image_size = image_size

    def __call__(self, data_sample: dict) -> dict:
        ret = dict(data_sample)
        ret["img"] = F.normalize(np.asarray(ret["img"], np.float32) / 255.0, self.mean, self.std)
        if ret.get("gt_seg_map") is not None:
            ret["gt_seg_map"] = np.asarray(ret["gt_seg_map"])
        return ret

    @classmethod
    def from_config(cls, cfg=None):
        cfg = cfg or {}
        return cls(image_size=cfg.get("image_size", 224), mean=cfg.get("mean"),
                   std=cfg.get("std"), strong_aug=cfg.get("strong_aug", False),
                   identity=cfg.get("identity", False))


PROCESSORS = {"blip_caption": BlipCaptionProcessor, "loc_image_train": LocImageTrainProcessor}


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
