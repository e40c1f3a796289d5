"""jsonl annotations, an optional RAM preload and collation (counterpart of
``myriad_tpu/datasets/base_dataset.py``).  Images, PNG or JPEG, are decoded
by the port's own readers (``datasets/jpeg.read_image``), as
``Image.open(path).convert("RGB")`` gives them."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Sequence

import numpy as np

from myriad_tpu_torch.datasets.jpeg import read_image


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


class BaseDataset:
    """The annotations of ``ann_paths`` (relative to ``vis_root`` unless
    absolute) and, with ``is_preload``, every image decoded up front.  The
    JAX package decodes with a pool of 16 threads, in which PIL releases
    the GIL; the port's decoder holds it (numpy steps over small arrays), so
    threads only add contention and the port decodes in order."""

    def __init__(self, vis_processor=None, text_processor=None, vis_root: str = "",
                 ann_paths: Sequence[str] = (), is_preload: bool = False):
        self.vis_processor = vis_processor
        self.text_processor = text_processor
        self.vis_root = vis_root
        self.ann_paths = list(ann_paths)
        self.is_preload = is_preload
        self.annotation: List[Dict] = []
        self.load_annotations()
        self._cache: Dict[str, np.ndarray] = {}
        if is_preload:
            for ann in self.annotation:
                self._preload_item(ann)

    def load_annotations(self) -> None:
        """Every row of the ``ann_paths`` files (relative to ``vis_root`` unless absolute)."""
        for path in self.ann_paths:
            full = path if os.path.isabs(path) else os.path.join(self.vis_root, path)
            self.annotation.extend(self.read_annotations(full))

    def read_annotations(self, path: str) -> List[Dict]:
        """The rows of one annotation file: jsonl here, a subclass's own format there."""
        return read_jsonl(path)

    def _preload_item(self, ann: Dict) -> None:
        rel = ann.get("img_path") or ann.get("image")
        self._cache[rel] = read_image(os.path.join(self.vis_root, rel))

    def prepare_img(self, index: int) -> np.ndarray:
        """The image as ``Image.open(path).convert("RGB")`` gives it: (H, W, 3) uint8."""
        rel = self.annotation[index]["img_path"]
        if self.is_preload and rel in self._cache:
            return self._cache[rel]
        return read_image(os.path.join(self.vis_root, rel))

    def __len__(self) -> int:
        return len(self.annotation)

    def collater(self, samples: Sequence[Dict]) -> Dict:
        return default_collate(samples)
