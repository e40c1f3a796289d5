"""The anomaly-detection dataset (counterpart of
``myriad_tpu/datasets/anomaly_detection.py``).

Each item is the PNG or JPEG at ``img_path`` decoded as PIL would (``jpeg.read_image``),
resized and centre-cropped as PIL would (``processors.functional``), and
normalised to float32 HWC with the CLIP statistics, as the JAX dataset's
``LocImageTrainProcessor(identity=True)`` does: the same floats to the bit.
At ``stage="train"`` an item also carries an anomalous twin: NSA synthesis
(``datasets/nsa.py``) pastes patches of another random image of the set into
the image with the per-class tables below, and ``aug_text_input`` says
whether the twin shows an anomaly (``version`` 0-2 pick the answer texts).
The dataset's one generator (``seed``) makes every draw, in the JAX dataset's
order.  With ``with_mask`` and a ``ve_root`` an item carries ``masks``, the
precomputed vision-expert mask of its image (``prepare_ve``) read as
``cv2.imread(GRAYSCALE)`` and ``cv2.resize`` read it, when the file exists.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from myriad_tpu_torch.datasets.base_dataset import BaseDataset
from myriad_tpu_torch.datasets.cv_ops import NORMAL_CLONE, resize_linear
from myriad_tpu_torch.datasets.nsa import patch_ex
from myriad_tpu_torch.datasets.png import read_png_gray
from myriad_tpu_torch.processors import functional as F

# question prompts, answer templates and NSA tables, copied from
# myriad_tpu/datasets/anomaly_detection.py (which imports cv2);
# tests/test_torch_evaluate.py and tests/test_torch_train_data.py hold the
# copies equal.  The reference feeds variant [1] for all three question slots.
QUESTION_PROMPTS = [
    "This image may be simulated by photo editing. According on IAD expert opinions, find out if there are defects in this image.",
    "This image may be simulated by photo editing. According to IAD expert opinions and corresponding visual descriptions, find out if there are defects in this image.",
    "This image may be simulated by photo editing. According to IAD expert visual descriptions, find out if there are defects in this image.",
]
NORMAL_DESCRIBE = "No, there exists no anomalies in the image."
ABNORMAL_DESCRIBE = "Yes, there exists anomalies in the image."
ABNORMAL_DESCRIBE_V1 = (
    "Yes, there exists anomalies in the image. These anomalies are simulated by photo editing."
)

MVTEC_WIDTH_BOUNDS_PCT = {
    "bottle": ((0.03, 0.4), (0.03, 0.4)), "cable": ((0.05, 0.4), (0.05, 0.4)),
    "capsule": ((0.03, 0.15), (0.03, 0.4)), "hazelnut": ((0.03, 0.35), (0.03, 0.35)),
    "metal_nut": ((0.03, 0.4), (0.03, 0.4)), "pill": ((0.03, 0.2), (0.03, 0.4)),
    "screw": ((0.03, 0.12), (0.03, 0.12)), "toothbrush": ((0.03, 0.4), (0.03, 0.2)),
    "transistor": ((0.03, 0.4), (0.03, 0.4)), "zipper": ((0.03, 0.4), (0.03, 0.2)),
    "carpet": ((0.03, 0.4), (0.03, 0.4)), "grid": ((0.03, 0.4), (0.03, 0.4)),
    "leather": ((0.03, 0.4), (0.03, 0.4)), "tile": ((0.03, 0.4), (0.03, 0.4)),
    "wood": ((0.03, 0.4), (0.03, 0.4)),
}
MVTEC_INTENSITY_LOGISTIC_PARAMS = {
    "bottle": (1 / 12, 24), "cable": (1 / 12, 24), "capsule": (1 / 2, 4),
    "hazelnut": (1 / 12, 24), "metal_nut": (1 / 3, 7), "pill": (1 / 3, 7),
    "screw": (1, 3), "toothbrush": (1 / 6, 15), "transistor": (1 / 6, 15),
    "zipper": (1 / 6, 15), "carpet": (1 / 3, 7), "grid": (1 / 3, 7),
    "leather": (1 / 3, 7), "tile": (1 / 3, 7), "wood": (1 / 6, 15),
}
MVTEC_BACKGROUND = {
    "bottle": (200, 60), "screw": (200, 60), "capsule": (200, 60),
    "zipper": (200, 60), "hazelnut": (20, 20), "pill": (20, 20),
    "toothbrush": (20, 20), "metal_nut": (20, 20),
}


def position_phrases(boxes: Sequence[Sequence[float]], img_size: int = 224) -> List[str]:
    """3x3-grid phrases from the boxes' first corner (the reference's axes)."""
    out = []
    for box in boxes:
        cx, cy = box[0] / img_size, box[1] / img_size
        if cx <= 1 / 3:
            out.append("upper left" if cy <= 1 / 3 else ("top" if cy <= 2 / 3 else "upper right"))
        elif cx <= 2 / 3:
            out.append("left" if cy <= 1 / 3 else ("center" if cy <= 2 / 3 else "right"))
        else:
            out.append("lower left" if cy <= 1 / 3 else ("bottom" if cy <= 2 / 3 else "lower right"))
    return out


def describe_from_positions(positions: List[str]) -> str:
    if len(positions) == 1:
        return ("Yes, there exists anomalies in the image, at the " + positions[0]
                + " of the image.")
    desc = "Yes, there exists anomalies in the image, they are at the " + positions[0]
    for i in range(1, len(positions)):
        if positions[i] != positions[i - 1]:
            if i != len(positions) - 1:
                desc += ", " + positions[i]
            else:
                desc += " and " + positions[i] + " of the image."
        elif i == len(positions) - 1:
            desc += " of the image."
    return desc


class AnomalyDetectionDataset(BaseDataset):
    """The MVTec AD / VisA annotations and their images (test stage), with the
    NSA twins at the train stage."""

    DatasetName = "AnomalyDetection"

    def __init__(self, vis_root: str, ve_root: str = "", ann_paths: Sequence[str] = (),
                 img_size: int = 224, crop_size: int = 224, with_mask: bool = False,
                 is_preload: bool = False, stage: str = "test", vis_processor=None,
                 text_processor=None, version: int = 0, with_ref: bool = False,
                 with_pos: bool = False, nsa_max_width: float = 0.4,
                 seed: Optional[int] = None):
        if stage not in ("test", "train"):
            raise ValueError(f"AnomalyDetectionDataset stage={stage!r}: 'test' or 'train'")
        self.with_mask, self.ve_root = with_mask, ve_root
        self.stage = stage
        self.img_size = img_size
        self.crop_size = crop_size
        self.version = version
        self.rng = np.random.default_rng(seed)
        self.is_visa = bool(ann_paths) and "VISA" in os.path.basename(ann_paths[0]).upper()
        self.self_sup_args: Dict = {
            "num_patches": 2, "min_object_pct": 0, "min_overlap_pct": 0.25,
            "gamma_params": (2, 0.05, 0.03), "resize": True, "shift": True, "same": False,
            "mode": NORMAL_CLONE, "label_mode": "logistic-intensity",
        }
        if self.is_visa:
            self.self_sup_args.update({
                "width_bounds_pct": ((0.03, nsa_max_width), (0.03, nsa_max_width)),
                "intensity_logistic_params": (1 / 12, 24), "skip_background": None,
                "resize_bounds": (0.5, 2)})
        super().__init__(vis_processor, text_processor, vis_root, ann_paths, is_preload)

    def prepare_ve(self, index: int) -> Optional[np.ndarray]:
        """The precomputed vision-expert mask of item ``index`` (its
        annotation's ``ve_path``, else its image path with ``.png``, under
        ``ve_root``) resized to ``crop_size`` as OpenCV's ``INTER_LINEAR``,
        float32 in [0, 1]; None when the file is missing."""
        ann = self.annotation[index]
        ve_rel = ann.get("ve_path") or os.path.splitext(ann["img_path"])[0] + ".png"
        path = os.path.join(self.ve_root, ve_rel)
        if not os.path.isfile(path):
            return None
        m = resize_linear(read_png_gray(path), (self.crop_size, self.crop_size))
        return m.astype(np.float32) / 255.0

    def _resize_crop(self, img: np.ndarray) -> np.ndarray:
        return F.center_crop(F.resize_bicubic(img, self.img_size), self.crop_size)

    def _process(self, sample: Dict) -> Dict:
        if self.vis_processor is not None:
            return self.vis_processor(sample)
        return dict(sample, img=F.normalize(F.to_float_hwc(sample["img"])))

    def get_class_name(self, index: int):
        return ("visa" if self.is_visa else "mvtec"), self.annotation[index]["img_path"].split("/")[1]

    def _twin(self, index: int, image: np.ndarray):
        """NSA synthesis against another random image: (the processed twin,
        the answer for an anomalous image)."""
        src_index = int(self.rng.integers(len(self)))
        while src_index == index and len(self) > 1:
            src_index = int(self.rng.integers(len(self)))
        src_image = self._resize_crop(self.prepare_img(src_index))
        ds, class_name = self.get_class_name(index)
        per_class = {}
        if ds == "mvtec":
            per_class = {
                "width_bounds_pct": MVTEC_WIDTH_BOUNDS_PCT.get(class_name),
                "intensity_logistic_params": MVTEC_INTENSITY_LOGISTIC_PARAMS.get(class_name),
                "skip_background": MVTEC_BACKGROUND.get(class_name),
            }
        args = {**self.self_sup_args, **per_class}
        aug_image, mask, boxes = patch_ex(image, src_image, rng=self.rng, **args)
        while np.sum(mask) == 0:
            aug_image, mask, boxes = patch_ex(image, src_image, rng=self.rng, **args)
        describe = ABNORMAL_DESCRIBE
        if boxes and self.version >= 2:
            describe = describe_from_positions(position_phrases(boxes, self.crop_size))
        return self._process({"img": aug_image, "gt_seg_map": mask[..., 0]}), describe

    def __getitem__(self, index: int) -> Dict:
        ann = self.annotation[index]
        image = self._resize_crop(self.prepare_img(index))
        aug_sample, describe = None, ABNORMAL_DESCRIBE
        if self.stage == "train":
            aug_sample, describe = self._twin(index, image)
        data_sample = self._process({"img": image})
        if self.version == 0:
            abnormal = ABNORMAL_DESCRIBE
        elif self.version == 1:
            abnormal = ABNORMAL_DESCRIBE_V1
        else:
            abnormal = describe
        q = "<Img><ImageHere></Img>" + QUESTION_PROMPTS[1]
        ret = {
            "image": np.asarray(data_sample["img"], np.float32),
            "scene": ann["img_path"].split("/")[1],
            "question": q,
            "question2": q,
            "question3": q,
            "text_input": NORMAL_DESCRIBE,
            "image_id": index,
            "is_anomaly": ann.get("is_anomaly") == "1" or ann.get("is_anomaly") is True,
            "img_path": os.path.join(self.vis_root, ann["img_path"]),
        }
        if self.with_mask and self.ve_root:
            ve = self.prepare_ve(index)
            if ve is not None:
                ret["masks"] = ve[..., None]
        if aug_sample is not None:
            ret["aug_image"] = np.asarray(aug_sample["img"], np.float32)
            ret["aug_text_input"] = (NORMAL_DESCRIBE
                                     if float(np.sum(aug_sample["gt_seg_map"])) == 0.0
                                     else abnormal)
        return ret


# the two-class set's instructions, copied from myriad_tpu/datasets/anomaly_detection.py
TWOCLS_INSTRUCTIONS = [
    "This image has not been edited. According to IAD expert opinions, find out if there are defects in this image.",
    "This image has not been edited. According to IAD expert opinions and corresponding visual descriptions, find out if there are defects in this image.",
    "This image has not been edited. According to IAD expert visual descriptions, find out if there are defects in this image.",
]


class TwoClassAnomalyDetectionDataset(BaseDataset):
    """The supervised two-class set over real test images, normal and
    anomalous (PNG or JPEG): each image resized and centre-cropped as PIL
    would, then through ``vis_processor`` as {"img": uint8} (the 2cls
    config names none, so the item's ``image`` is the crop's 0-255 values
    as float32, as in the JAX dataset), answered by its ``is_anomaly``."""

    DatasetName = "TwoClassAnomalyDetection"

    def __init__(self, vis_processor, text_processor, vis_root: str, ve_root: str = "",
                 ann_paths: Sequence[str] = (), img_size: int = 224, crop_size: int = 224,
                 version: int = 0, is_preload: bool = False, stage: str = "train",
                 seed: Optional[int] = None):
        self.ve_root = ve_root
        self.stage = stage
        self.img_size = img_size
        self.crop_size = crop_size
        self.version = version
        self.rng = np.random.default_rng(seed)
        super().__init__(vis_processor, text_processor, vis_root, ann_paths, is_preload)

    def __getitem__(self, index: int) -> Dict:
        ann = self.annotation[index]
        image = F.center_crop(F.resize_bicubic(self.prepare_img(index), self.img_size),
                              self.crop_size)
        data_sample = self.vis_processor({"img": image})
        is_anomaly = ann.get("is_anomaly") == "1" or ann.get("is_anomaly") is True
        q = "<Img><ImageHere></Img>" + TWOCLS_INSTRUCTIONS[1]
        return {
            "image": np.asarray(data_sample["img"], np.float32),
            "scene": ann["img_path"].split("/")[1],
            "question": q,
            "question2": q,
            "question3": q,
            "text_input": ABNORMAL_DESCRIBE if is_anomaly else NORMAL_DESCRIBE,
            "image_id": index,
            "is_anomaly": is_anomaly,
            "img_path": os.path.join(self.vis_root, ann["img_path"]),
        }
