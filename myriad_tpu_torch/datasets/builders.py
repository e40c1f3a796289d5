"""Dataset builders (counterpart of ``myriad_tpu/datasets/builders.py``): a
dataset's config node (its defaults from ``configs/`` merged under the user's
section by ``common.config.Config``) -> {split: dataset}.

``anomaly_detection`` (the LoRA fine-tuning set, NSA twins) and
``two_class_anomaly_detection`` (real test images, ``2cls.yaml``); ``laion``
and ``cc_sbu`` (tar shards at ``build_info.storage``, MiniGPT-4's stage 1);
``cc_sbu_align`` (``filter_cap.json`` and ``image/`` under the storage,
stage 2); ``panda`` (PandaGPT's instruction json).  Every builder builds
the ``train`` split with its ``train`` processors and sets the config's
``sample_ratio`` on its datasets (the runner mixes several by it).
"""

from __future__ import annotations

import logging
import os
from typing import Dict

from myriad_tpu_torch.datasets.anomaly_detection import (AnomalyDetectionDataset,
                                                         TwoClassAnomalyDetectionDataset)
from myriad_tpu_torch.datasets.caption_datasets import (CCSBUAlignDataset,
                                                        PandaInstructionDataset,
                                                        TarShardIterableDataset)
from myriad_tpu_torch.processors.blip_processors import build_processor


class BaseDatasetBuilder:
    def __init__(self, cfg=None):
        self.config = cfg or {}

    def processors(self):
        """The ``train`` (vis, text) processors of the config."""
        cfg = self.config
        return (build_processor((cfg.get("vis_processor") or {}).get("train")),
                build_processor((cfg.get("text_processor") or {}).get("train")))

    @property
    def info(self):
        return self.config.get("build_info") or {}

    def build_datasets(self) -> Dict:
        logging.info("Building datasets for %s", type(self).__name__)
        datasets = self.build()
        ratio = self.config.get("sample_ratio")
        if ratio is not None:
            for ds in datasets.values():
                ds.sample_ratio = float(ratio)
        return datasets

    def build(self) -> Dict:  # pragma: no cover - overridden
        raise NotImplementedError


class AnomalyDetectionBuilder(BaseDatasetBuilder):
    """The training set: ``build_info`` (storage, ve_storage, ann_paths),
    ``img_size``, ``crop_size``, ``version``, ``is_preload``, ``augment
    .nsa_max_width``, ``seed`` and the ``train`` processors."""

    def build(self) -> Dict:
        cfg, info = self.config, self.info
        vis, txt = self.processors()
        return {"train": AnomalyDetectionDataset(
            vis_root=info.get("storage", ""), ve_root=info.get("ve_storage", ""),
            ann_paths=info.get("ann_paths", []), img_size=cfg.get("img_size", 224),
            crop_size=cfg.get("crop_size", 224), with_mask=cfg.get("with_mask", False),
            is_preload=cfg.get("is_preload", False), stage="train",
            vis_processor=vis, text_processor=txt,
            version=cfg.get("version", 0), with_ref=cfg.get("with_ref", False),
            with_pos=cfg.get("with_pos", False),
            nsa_max_width=(cfg.get("augment") or {}).get("nsa_max_width", 0.4),
            seed=cfg.get("seed", None))}


class TwoClassAnomalyDetectionBuilder(BaseDatasetBuilder):
    def build(self) -> Dict:
        cfg, info = self.config, self.info
        vis, txt = self.processors()
        return {"train": TwoClassAnomalyDetectionDataset(
            vis_processor=vis, text_processor=txt, vis_root=info.get("storage", ""),
            ve_root=info.get("ve_storage", ""), ann_paths=info.get("ann_paths", []),
            img_size=cfg.get("img_size", 224), crop_size=cfg.get("crop_size", 224),
            version=cfg.get("version", 0), is_preload=cfg.get("is_preload", False),
            stage="train")}


class WebBuilder(BaseDatasetBuilder):
    """``laion`` and ``cc_sbu``: the shards at ``build_info.storage`` (the
    reader's seed 0, as the JAX builder leaves it)."""

    def build(self) -> Dict:
        vis, txt = self.processors()
        return {"train": TarShardIterableDataset(vis_processor=vis, text_processor=txt,
                                                 location=self.info.get("storage", ""))}


class CCSBUAlignBuilder(BaseDatasetBuilder):
    def build(self) -> Dict:
        vis, txt = self.processors()
        storage = self.info.get("storage", "")
        return {"train": CCSBUAlignDataset(
            vis_processor=vis, text_processor=txt, vis_root=storage,
            ann_paths=[os.path.join(storage, "filter_cap.json")])}


class PandaBuilder(BaseDatasetBuilder):
    def build(self) -> Dict:
        vis, txt = self.processors()
        return {"train": PandaInstructionDataset(
            vis_processor=vis, text_processor=txt, vis_root=self.info.get("storage", ""),
            ann_paths=self.info.get("ann_paths", []))}


BUILDERS = {"anomaly_detection": AnomalyDetectionBuilder,
            "two_class_anomaly_detection": TwoClassAnomalyDetectionBuilder,
            "laion": WebBuilder, "cc_sbu": WebBuilder, "cc_sbu_align": CCSBUAlignBuilder,
            "panda": PandaBuilder}


def get_builder_class(name: str):
    try:
        return BUILDERS[name]
    except KeyError:
        raise NotImplementedError(f"dataset {name!r} is not ported; the port builds "
                                  f"{', '.join(sorted(BUILDERS))}") from None
