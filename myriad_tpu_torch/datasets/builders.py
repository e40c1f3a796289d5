"""Dataset builders (counterpart of ``myriad_tpu/datasets/builders.py``): a
dataset's config node (its defaults from ``configs/`` merged under the user's
section by ``common.config.Config``) -> {split: dataset}.  The port builds
``anomaly_detection``, the dataset of the stage-2 LoRA fine-tuning config."""

from __future__ import annotations

import logging
from typing import Dict

from myriad_tpu_torch.datasets.anomaly_detection import AnomalyDetectionDataset
from myriad_tpu_torch.processors.blip_processors import build_processor


class AnomalyDetectionBuilder:
    """The training set: ``build_info`` (storage, ve_storage, ann_paths),
    ``img_size``, ``crop_size``, ``version``, ``is_preload``, ``augment
    .nsa_max_width``, ``seed`` and the ``train`` processors."""

    def __init__(self, cfg=None):
        self.config = cfg or {}

    def build_datasets(self) -> Dict:
        logging.info("Building datasets for %s", type(self).__name__)
        cfg = self.config
        vis = (cfg.get("vis_processor") or {}).get("train")
        txt = (cfg.get("text_processor") or {}).get("train")
        info = cfg.get("build_info") or {}
        dataset = AnomalyDetectionDataset(
            vis_root=info.get("storage", ""), ve_root=info.get("ve_storage", ""),
            ann_paths=info.get("ann_paths", []), img_size=cfg.get("img_size", 224),
            crop_size=cfg.get("crop_size", 224), with_mask=cfg.get("with_mask", False),
            is_preload=cfg.get("is_preload", False), stage="train",
            vis_processor=build_processor(vis), text_processor=build_processor(txt),
            version=cfg.get("version", 0), with_ref=cfg.get("with_ref", False),
            with_pos=cfg.get("with_pos", False),
            nsa_max_width=(cfg.get("augment") or {}).get("nsa_max_width", 0.4),
            seed=cfg.get("seed", None))
        ratio = cfg.get("sample_ratio")
        if ratio is not None:
            dataset.sample_ratio = float(ratio)
        return {"train": dataset}


BUILDERS = {"anomaly_detection": AnomalyDetectionBuilder}


def get_builder_class(name: str):
    try:
        return BUILDERS[name]
    except KeyError:
        raise NotImplementedError(f"dataset {name!r} is not ported; the port builds "
                                  f"{', '.join(sorted(BUILDERS))}") from None
