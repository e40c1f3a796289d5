"""Caption datasets of MiniGPT-4's stage-1 and stage-2 training (counterpart
of ``myriad_tpu/datasets/caption_datasets.py``).

``TarShardIterableDataset`` reads webdataset-style ``.tar`` shards without
the webdataset package, as the JAX reader does: members grouped by key (an
image ``.jpg``/``.jpeg``/``.png`` with a ``.json`` ``caption`` or a
``.txt``; incomplete groups skipped), shards resampled with
``rng.integers``, samples through a swap-and-``pop`` shuffle buffer that is
drained at the end of each shard, so a seed gives the JAX stream's order.
``CaptionDataset`` / ``CCSBUAlignDataset`` (json annotations, images under
``vis_root/image``) and ``PandaInstructionDataset`` (the first QA turn of a
PandaGPT instruction) are map-style.  Images are decoded by the port's own
readers (``datasets/jpeg.decode_image``) as ``convert("RGB")`` gives them.
"""

from __future__ import annotations

import glob
import json
import os
import tarfile
from typing import Dict, Iterator, List, Optional

import numpy as np

from myriad_tpu_torch.datasets.base_dataset import BaseDataset
from myriad_tpu_torch.datasets.jpeg import decode_image, read_image


class TarShardIterableDataset:
    """An endless, resampled stream of {"image", "text_input"} over tar shards.

    ``location`` is a glob (``*?[``), a directory (its ``*.tar``) or one
    path taken literally: a brace pattern such as ``{00000..01255}.tar`` is
    not expanded, as in the JAX reader, and fails at the first draw."""

    def __init__(self, vis_processor, text_processor, location: str, seed: int = 0,
                 shuffle_buffer: int = 1000):
        self.vis_processor = vis_processor
        self.text_processor = text_processor
        self.shards = sorted(glob.glob(location)) if any(
            c in location for c in "*?[") else [location]
        if os.path.isdir(location):
            self.shards = sorted(glob.glob(os.path.join(location, "*.tar")))
        if not self.shards:
            raise FileNotFoundError(f"no tar shards match {location}")
        self.rng = np.random.default_rng(seed)
        self.shuffle_buffer = shuffle_buffer

    def _iter_shard(self, path: str) -> Iterator[Dict]:
        with tarfile.open(path) as tar:
            group: Dict[str, bytes] = {}
            key = None
            for member in tar:
                if not member.isfile():
                    continue
                base, ext = os.path.splitext(member.name)
                if key is not None and base != key and group:
                    sample = self._assemble(group)
                    if sample is not None:
                        yield sample
                    group = {}
                key = base
                group[ext.lstrip(".").lower()] = tar.extractfile(member).read()
            if group:
                sample = self._assemble(group)
                if sample is not None:
                    yield sample

    def _assemble(self, group: Dict[str, bytes]) -> Optional[Dict]:
        img_bytes = group.get("jpg") or group.get("jpeg") or group.get("png")
        if img_bytes is None:
            return None
        caption = None
        if "json" in group:
            caption = json.loads(group["json"]).get("caption")
        elif "txt" in group:
            caption = group["txt"].decode("utf-8")
        if caption is None:
            return None
        return {"image": np.asarray(self.vis_processor(decode_image(img_bytes)), np.float32),
                "text_input": self.text_processor(caption)}

    def __iter__(self) -> Iterator[Dict]:
        buf: List[Dict] = []
        while True:  # resampled shards: an endless stream
            shard = self.shards[int(self.rng.integers(len(self.shards)))]
            for sample in self._iter_shard(shard):
                buf.append(sample)
                if len(buf) >= self.shuffle_buffer:
                    idx = int(self.rng.integers(len(buf)))
                    buf[idx], buf[-1] = buf[-1], buf[idx]
                    yield buf.pop()
            while buf:
                yield buf.pop()


class CaptionDataset(BaseDataset):
    """LAVIS caption annotations: a json list, or its ``annotations``, of
    ``image`` (else ``{image_id}.jpg``) and ``caption``, images under
    ``vis_root/image``."""

    def read_annotations(self, path: str) -> List[Dict]:
        with open(path) as f:
            data = json.load(f)
        return data["annotations"] if "annotations" in data else data

    def __getitem__(self, index: int) -> Dict:
        ann = self.annotation[index]
        rel = ann.get("image", f"{ann['image_id']}.jpg")
        img = read_image(os.path.join(self.vis_root, "image", rel))
        return {"image": np.asarray(self.vis_processor(img), np.float32),
                "text_input": self.text_processor(ann["caption"]),
                "image_id": ann.get("image_id", index)}


class CCSBUAlignDataset(CaptionDataset):
    """MiniGPT-4's stage-2 alignment data (the cc_sbu_align layout)."""


class PandaInstructionDataset(BaseDataset):
    """PandaGPT's visual-instruction json; the first QA turn only."""

    def read_annotations(self, path: str) -> List[Dict]:
        with open(path) as f:
            return json.load(f)

    def __getitem__(self, index: int) -> Dict:
        ann = self.annotation[index]
        img = read_image(os.path.join(self.vis_root, ann.get("image_name", ann.get("image"))))
        conv = ann["conversation"]
        question = conv[0]["value"] if isinstance(conv[0], dict) else conv[0]
        answer = conv[1]["value"] if isinstance(conv[1], dict) else conv[1]
        return {"image": np.asarray(self.vis_processor(img), np.float32),
                "question": "<Img><ImageHere></Img>" + question, "text_input": answer,
                "image_id": index}
