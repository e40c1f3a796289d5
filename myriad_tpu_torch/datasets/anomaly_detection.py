"""The anomaly-detection test set (counterpart of
``myriad_tpu/datasets/anomaly_detection.py`` at ``stage="test"`` and of
``myriad_tpu/datasets/base_dataset.py``).

Each item is the PNG at ``img_path`` decoded as PIL would (``png.read_png``),
resized and centre-cropped as PIL would (``processors.functional``), and
normalised to float32 HWC with the CLIP statistics, as the JAX dataset's
``LocImageTrainProcessor(identity=True)`` does: the same floats to the bit.
The training stage (NSA synthesis, cv2) and precomputed vision-expert masks
(``with_mask``, cv2) are not ported and raise.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Sequence

import numpy as np

from myriad_tpu_torch.datasets.png import read_png
from myriad_tpu_torch.processors import functional as F

# question prompts and the answer templates, copied from
# myriad_tpu/datasets/anomaly_detection.py (which imports cv2);
# tests/test_torch_evaluate.py holds the copies equal.  The reference feeds
# variant [1] for all three question slots.
QUESTION_PROMPTS = [
    "This image may be simulated by photo editing. According on IAD expert opinions, find out if there are defects in this image.",
    "This image may be simulated by photo editing. According to IAD expert opinions and corresponding visual descriptions, find out if there are defects in this image.",
    "This image may be simulated by photo editing. According to IAD expert visual descriptions, find out if there are defects in this image.",
]
NORMAL_DESCRIBE = "No, there exists no anomalies in the image."
ABNORMAL_DESCRIBE = "Yes, there exists anomalies in the image."


def read_jsonl(path: str) -> List[Dict]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def default_collate(samples: Sequence[Dict]) -> Dict:
    """Stack arrays, keep strings/objects as lists."""
    out: Dict[str, Any] = {}
    keys = set(samples[0])
    for s in samples[1:]:
        keys &= set(s)
    for k in keys:
        vals = [s[k] for s in samples]
        v0 = vals[0]
        if isinstance(v0, np.ndarray):
            out[k] = np.stack(vals)
        elif isinstance(v0, (int, float, bool, np.integer, np.floating, np.bool_)):
            out[k] = np.asarray(vals)
        else:
            out[k] = list(vals)
    return out


class AnomalyDetectionDataset:
    """The MVTec AD / VisA test annotations and their images."""

    def __init__(self, vis_root: str, ve_root: str = "", ann_paths: Sequence[str] = (),
                 img_size: int = 224, crop_size: int = 224, with_mask: bool = False,
                 is_preload: bool = False, stage: str = "test"):
        if stage != "test":
            raise NotImplementedError(f"AnomalyDetectionDataset stage={stage!r}: the training "
                                      "stage (NSA synthesis, cv2) is not ported")
        if with_mask and ve_root:
            raise NotImplementedError(f"AnomalyDetectionDataset with_mask=True, ve_root="
                                      f"{ve_root!r}: precomputed vision-expert masks "
                                      "(prepare_ve, cv2) are not ported")
        self.vis_root = vis_root
        self.img_size = img_size
        self.crop_size = crop_size
        self.annotation: List[Dict] = []
        for path in ann_paths:
            full = path if os.path.isabs(path) else os.path.join(vis_root, path)
            self.annotation.extend(read_jsonl(full))
        self.is_preload = is_preload
        self._cache: Dict[str, np.ndarray] = {}
        if is_preload:
            with ThreadPoolExecutor(16) as pool:  # the JAX dataset's preload pool
                list(pool.map(self._preload_item, self.annotation))

    def _preload_item(self, ann: Dict) -> None:
        rel = ann.get("img_path") or ann.get("image")
        self._cache[rel] = read_png(os.path.join(self.vis_root, rel))

    def prepare_img(self, index: int) -> np.ndarray:
        """The image as ``Image.open(path).convert("RGB")`` gives it: (H, W, 3) uint8."""
        rel = self.annotation[index]["img_path"]
        if self.is_preload and rel in self._cache:
            return self._cache[rel]
        return read_png(os.path.join(self.vis_root, rel))

    def __len__(self) -> int:
        return len(self.annotation)

    def __getitem__(self, index: int) -> Dict:
        ann = self.annotation[index]
        image = F.center_crop(F.resize_bicubic(self.prepare_img(index), self.img_size),
                              self.crop_size)
        q = "<Img><ImageHere></Img>" + QUESTION_PROMPTS[1]
        return {
            "image": F.normalize(F.to_float_hwc(image)),
            "scene": ann["img_path"].split("/")[1],
            "question": q,
            "question2": q,
            "question3": q,
            "text_input": NORMAL_DESCRIBE,
            "image_id": index,
            "is_anomaly": ann.get("is_anomaly") == "1" or ann.get("is_anomaly") is True,
            "img_path": os.path.join(self.vis_root, ann["img_path"]),
        }

    def collater(self, samples: Sequence[Dict]) -> Dict:
        return default_collate(samples)
