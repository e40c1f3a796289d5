"""The training data of the port against the JAX package's, on the CPU.

* ``datasets/cv_ops.py`` against OpenCV: ``median_blur`` and ``resize_linear``
  equal to ``cv2.medianBlur`` and ``cv2.resize`` (INTER_LINEAR) to the byte;
  ``seamless_clone`` within 2 grey levels of ``cv2.seamlessClone`` at every
  pixel (NORMAL_CLONE and MIXED_CLONE), raising where OpenCV raises;
* ``datasets/nsa.py``'s ``patch_ex`` against the JAX one over 20 seeds each on
  RGB and gray images with the MVTec tables: the same boxes, the same patch
  masks (``_paste_one``) and the same generator state afterwards, the image
  within the clone tolerance;
* the train-stage dataset's items and the runner's loader batches (the same
  seed, ``num_workers: 0``) against the JAX ones: images within the clone
  tolerance, texts equal; the copied tables and processors equal.
"""

import cv2
import numpy as np
import pytest

from fixtures import make_ad_dataset
from myriad_tpu.datasets import anomaly_detection as jad
from myriad_tpu.datasets import nsa as jnsa
from myriad_tpu.datasets.loaders import DataLoader as JaxDataLoader
from myriad_tpu.processors import blip_processors as jbp
from myriad_tpu_torch.datasets import anomaly_detection as tad
from myriad_tpu_torch.datasets import cv_ops
from myriad_tpu_torch.datasets import nsa as tnsa
from myriad_tpu_torch.datasets.loaders import DataLoader
from myriad_tpu_torch.processors import blip_processors as tbp
import torch_threads  # noqa: F401  (one torch thread a test process)

CLONE_TOL = 2  # grey levels: the Poisson solve is float64 here, float32 in OpenCV
# the clone tolerance after LocImageTrainProcessor's normalisation
NORM_TOL = CLONE_TOL / 255.0 / float(np.min(jbp.F.CLIP_STD)) + 1e-6


def _image(rng, channels, size=224):
    yy, xx = np.mgrid[0:size, 0:size]
    base = np.stack([(xx // 4 + c * 40) % 256 for c in range(channels)], -1) // 2 + 60
    img = (base + rng.integers(0, 24, base.shape)).astype(np.uint8)
    img[size // 3:size // 2, size // 4:size // 2] = 230
    return img


def test_median_blur_and_resize_equal_opencv():
    rng = np.random.default_rng(0)
    for t in range(400):
        h, w = (int(v) for v in rng.integers(1, 90, 2))
        nh, nw = (int(v) for v in rng.integers(1, 120, 2))
        if t % 7 == 0:
            nh, nw = max(h // 2, 1), max(w // 2, 1)
        if t % 11 == 0:
            nh, nw = h, w
        shape = [(h, w), (h, w, 3)][t % 2]
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        if t % 5 == 0:
            img = (img > 128).astype(np.uint8)
        np.testing.assert_array_equal(cv_ops.resize_linear(img, (nw, nh)),
                                      cv2.resize(img, (nw, nh)), err_msg=f"{shape}->{nh, nw}")
        if len(shape) == 2:
            for k in (5, 7):
                np.testing.assert_array_equal(cv_ops.median_blur(img, k), cv2.medianBlur(img, k))


@pytest.mark.parametrize("mode", [cv2.NORMAL_CLONE, cv2.MIXED_CLONE])
def test_seamless_clone_within_two_grey_levels_of_opencv(mode):
    rng = np.random.default_rng(mode)
    compared = 0
    for t in range(40):
        dst = _image(rng, 3)
        ph, pw = (int(v) for v in rng.integers(8, 100, 2))
        src = rng.integers(0, 256, (ph, pw, 3), dtype=np.uint8)
        if t % 2:
            src = (src // 4 + 100).astype(np.uint8)
        mask = np.full((ph, pw, 1), 255, np.uint8)
        if t % 3 == 0:
            mask = (rng.random((ph, pw, 1)) > 0.1).astype(np.uint8) * 255
        mask[0], mask[-1], mask[:, 0], mask[:, -1] = 0, 0, 0, 0
        cx = int(rng.integers(pw // 2 + 1, 224 - pw // 2 - 1))
        cy = int(rng.integers(ph // 2 + 1, 224 - ph // 2 - 1))
        if t % 10 == 0:
            cx = 3  # the box leaves the destination
        try:  # OpenCV writes into the mask it is given: pass it copies
            ref = cv2.seamlessClone(src.copy(), dst.copy(), mask.copy(), (cx, cy), mode)
        except cv2.error:
            with pytest.raises(cv_ops.CloneError):
                cv_ops.seamless_clone(src, dst, mask, (cx, cy), mode)
            continue
        out = cv_ops.seamless_clone(src, dst, mask, (cx, cy), mode)
        assert int(np.abs(out.astype(int) - ref.astype(int)).max()) <= CLONE_TOL, t
        compared += 1
    assert compared >= 30


def _nsa_args(cls, mode=cv2.NORMAL_CLONE):
    return dict(num_patches=2, min_object_pct=0, min_overlap_pct=0.25,
                gamma_params=(2, 0.05, 0.03), resize=True, shift=True, same=False, mode=mode,
                label_mode="logistic-intensity",
                width_bounds_pct=jad.MVTEC_WIDTH_BOUNDS_PCT[cls],
                intensity_logistic_params=jad.MVTEC_INTENSITY_LOGISTIC_PARAMS[cls],
                skip_background=jad.MVTEC_BACKGROUND.get(cls))


@pytest.mark.parametrize("channels,cls", [(3, "bottle"), (1, "screw"), (3, "cable")])
def test_patch_ex_matches_jax(channels, cls):
    """20 seeds: the same boxes and generator state, the label map's support
    the same, the image and label within the clone tolerance."""
    for seed in range(20):
        r = np.random.default_rng(seed)
        dest, src = _image(r, channels), _image(r, channels)
        args = _nsa_args(cls, "mix" if seed % 4 == 3 else cv2.NORMAL_CLONE)
        rj, rt = np.random.default_rng(seed + 100), np.random.default_rng(seed + 100)
        ref = jnsa.patch_ex(dest, src, rng=rj, **args)
        out = tnsa.patch_ex(dest, src, rng=rt, **args)
        assert out[2] == ref[2], seed
        assert rt.bit_generator.state == rj.bit_generator.state, seed
        assert int(np.abs(out[0].astype(int) - ref[0].astype(int)).max()) <= CLONE_TOL, seed
        np.testing.assert_array_equal(out[1] > 0, ref[1] > 0, err_msg=str(seed))


@pytest.mark.parametrize("channels,cls", [(3, "bottle"), (1, "screw")])
def test_paste_one_gives_the_jax_patch_masks(channels, cls):
    """``_paste_one``, a patch at a time: the same coordinates and patch mask,
    the blend within the clone tolerance, the same draws."""
    for seed in range(20):
        r = np.random.default_rng(seed)
        dest, src = _image(r, channels), _image(r, channels)
        cfg = jnsa.PatchExConfig(**_nsa_args(cls))
        masks = [jnsa._object_mask(a, cfg.skip_background) for a in (src, dest)]
        tmasks = [tnsa._object_mask(a, cfg.skip_background) for a in (src, dest)]
        for a, b in zip(masks, tmasks):
            np.testing.assert_array_equal(a, b)
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        ref = jnsa._paste_one(dest, src, masks[1], masks[0], cfg.mode, cfg, 1.0, rj)
        out = tnsa._paste_one(dest, src, tmasks[1], tmasks[0], cfg.mode,
                              tnsa.PatchExConfig(**_nsa_args(cls)), 1.0, rt)
        assert out[1] == ref[1], seed
        assert (out[2] is None) == (ref[2] is None), seed
        if ref[2] is not None:
            np.testing.assert_array_equal(out[2], ref[2])
        assert int(np.abs(out[0].astype(int) - ref[0].astype(int)).max()) <= CLONE_TOL
        assert rt.bit_generator.state == rj.bit_generator.state


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ad_train"))
    make_ad_dataset(root, classes=("bottle", "screw"), n_train=4, img_size=64)
    return root


def _datasets(tree, version):
    kw = dict(vis_root=tree, ann_paths=["DC_MVTEC_train_normal.jsonl"], version=version,
              stage="train", seed=7)
    ref = jad.AnomalyDetectionDataset(
        jbp.LocImageTrainProcessor(identity=True), jbp.BlipCaptionProcessor(), **kw)
    ours = tad.AnomalyDetectionDataset(
        vis_processor=tbp.LocImageTrainProcessor(identity=True),
        text_processor=tbp.BlipCaptionProcessor(), **kw)
    return ref, ours


def _same_item(a, b):
    assert set(a) == set(b)
    for k, v in b.items():
        if k == "aug_image":
            np.testing.assert_allclose(a[k], v, rtol=0, atol=NORM_TOL)
        elif isinstance(v, np.ndarray):
            np.testing.assert_array_equal(a[k], v, err_msg=k)
        else:
            assert a[k] == v, k


@pytest.mark.parametrize("version", [0, 1, 2])
def test_train_items_match_jax(tree, version):
    ref, ours = _datasets(tree, version)
    assert len(ours) == len(ref) == 8
    for i in range(len(ref)):
        _same_item(ours[i], ref[i])
    assert ours.rng.bit_generator.state == ref.rng.bit_generator.state


def test_runner_loader_batches_match_jax(tree):
    """The runner's loader: AD batches halved to 2, shuffled from the seed,
    the last short batch dropped; two epochs' batches."""
    ref, ours = _datasets(tree, 0)
    jl = JaxDataLoader(ref, batch_size=2, shuffle=True, drop_last=True, num_workers=0,
                       seed=42)
    tl = DataLoader(ours, batch_size=2, shuffle=True, drop_last=True, num_workers=0, seed=42)
    assert len(tl) == len(jl) == 4
    for epoch in range(2):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        for a, b in zip(tl, jl):
            _same_item(a, b)


def test_copied_tables_and_processors_equal_the_originals():
    for name in ("MVTEC_WIDTH_BOUNDS_PCT", "MVTEC_INTENSITY_LOGISTIC_PARAMS",
                 "MVTEC_BACKGROUND", "QUESTION_PROMPTS", "NORMAL_DESCRIBE",
                 "ABNORMAL_DESCRIBE", "ABNORMAL_DESCRIBE_V1"):
        assert getattr(tad, name) == getattr(jad, name), name
    boxes = [[10, 200, 50, 60], [150, 20, 10, 10], [100, 100, 3, 3], [200, 120, 1, 1]]
    for n in range(1, 5):
        assert tad.position_phrases(boxes[:n]) == jad.position_phrases(boxes[:n])
        phrases = jad.position_phrases(boxes[:n])
        assert tad.describe_from_positions(phrases) == jad.describe_from_positions(phrases)
    assert (cv_ops.NORMAL_CLONE, cv_ops.MIXED_CLONE) == (cv2.NORMAL_CLONE, cv2.MIXED_CLONE)
    for text in ("Yes, there exists anomalies!  (A defect) #1.", "No" * 3, "a " * 80):
        assert tbp.BlipCaptionProcessor()(text) == jbp.BlipCaptionProcessor()(text)
    img = np.random.default_rng(0).integers(0, 256, (5, 6, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        tbp.LocImageTrainProcessor(identity=True)({"img": img})["img"],
        jbp.LocImageTrainProcessor(identity=True)({"img": img})["img"])
    # the geometric modes (identity False) crop from the processor's own generator
    for strong_aug in (False, True):
        kw = dict(image_size=4, identity=False, strong_aug=strong_aug, seed=2)
        sample = {"img": img, "gt_seg_map": (img[..., 0] > 128).astype(np.float32)}
        got = tbp.LocImageTrainProcessor(**kw)(dict(sample))
        ref = jbp.LocImageTrainProcessor(**kw)(dict(sample))
        np.testing.assert_array_equal(got["img"], ref["img"])
        np.testing.assert_array_equal(got["gt_seg_map"], ref["gt_seg_map"])
    assert not tbp.build_processor({"name": "loc_image_train", "identity": False}).identity
