"""The port's MiniGPT-4 data path against the JAX package's, on the CPU.

* the processors: ``blip2_image_train``/``blip2_image_eval``, ``raw_image``
  and both geometric modes of ``loc_image_train`` (``strong_aug`` and the
  shortest-edge crop), with and without a mask, equal at the same seed
  (tolerance 0); PIL's BILINEAR and NEAREST resizes and the other helpers of
  ``processors/functional`` at tolerance 0;
* the tar-shard stream: two shards, a shuffle buffer that fills and drains,
  and a wrap through the resampled shards: the sample order, the images
  (decoded and resized, tolerance 0) and the captions equal the JAX
  ``TarShardIterableDataset``'s for the same seed;
* ``CaptionDataset``, ``CCSBUAlignDataset``, ``PandaInstructionDataset`` and
  ``TwoClassAnomalyDetectionDataset`` items over PNG and JPEG files equal the
  JAX datasets' (tolerance 0);
* ``MultiIterLoader``'s draws and ``IterableBatcher``'s batches equal the
  JAX loaders'; every builder builds from its config, the ``sample_ratio`` set.
"""

import io
import json
import os
import tarfile

import numpy as np
import pytest
from PIL import Image

from myriad_tpu.datasets import anomaly_detection as jad
from myriad_tpu.datasets import builders as jbuilders
from myriad_tpu.datasets import caption_datasets as jcap
from myriad_tpu.datasets import loaders as jloaders
from myriad_tpu.processors import blip_processors as jbp
from myriad_tpu.processors import functional as JF
from myriad_tpu_torch.common.config import ConfigDict
from myriad_tpu_torch.datasets import anomaly_detection as tad
from myriad_tpu_torch.datasets import builders as tbuilders
from myriad_tpu_torch.datasets import caption_datasets as tcap
from myriad_tpu_torch.datasets import loaders as tloaders
from myriad_tpu_torch.datasets.png import encode_png
from myriad_tpu_torch.processors import blip_processors as tbp
from myriad_tpu_torch.processors import functional as F
import torch_threads  # noqa: F401  (one torch thread a test process)


def _smooth(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([(xx * 7 + seed) % 256, (yy * 3) % 256, ((xx * yy) // 5) % 256], -1)
    return np.clip(a + rng.normal(0, 12, a.shape), 0, 255).astype(np.uint8)


def _jpeg_bytes(arr, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _write_image(path, arr, kind):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(_jpeg_bytes(arr, quality=85) if kind == "jpg" else encode_png(arr))


# -- processors -------------------------------------------------------------------
@pytest.mark.parametrize("hw,out", [((37, 45), (28, 28)), ((300, 200), (224, 224)),
                                    ((5, 7), (13, 51)), ((1, 1), (3, 2))])
def test_bilinear_and_nearest_resizes_equal_pil(hw, out):
    rng = np.random.default_rng(hw[0] * 31 + hw[1])
    rgb = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    gray = rng.integers(0, 256, hw, dtype=np.uint8)
    for a in (rgb, gray):
        for kind, res in (("bilinear", Image.BILINEAR), ("bicubic", Image.BICUBIC)):
            np.testing.assert_array_equal(F.pil_resize(a, out[1], out[0], kind),
                                          np.asarray(Image.fromarray(a).resize(out[::-1], res)))
        np.testing.assert_array_equal(F.resize_nearest(a, out[1], out[0]),
                                      np.asarray(Image.fromarray(a).resize(out[::-1],
                                                                           Image.NEAREST)))
    np.testing.assert_array_equal(F.resize_shortest_edge(rgb, 17),
                                  np.asarray(JF.resize_shortest_edge(Image.fromarray(rgb), 17)))
    np.testing.assert_array_equal(F.expand2square(rgb, (10, 20, 30)),
                                  np.asarray(JF.expand2square(Image.fromarray(rgb), (10, 20, 30))))
    crop = (max(hw[0] + 3, 2), 3)
    np.testing.assert_array_equal(F.random_crop(rgb, crop, np.random.default_rng(1)),
                                  JF.random_crop(rgb, crop, np.random.default_rng(1)))


def test_blip2_and_raw_processors_equal_the_jax_ones():
    img = _smooth(61, 47, 1)
    cfg = {"name": "blip2_image_train", "image_size": 28}
    for name in ("blip2_image_train", "blip2_image_eval"):
        cfg["name"] = name
        got = tbp.build_processor(cfg)(img)
        ref = jbp.build_processor(ConfigDict(cfg))(Image.fromarray(img))
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    raw = {"name": "raw_image", "image_size": 40, "crop_size": 32}
    np.testing.assert_array_equal(tbp.build_processor(raw)(img),
                                  jbp.build_processor(ConfigDict(raw))(Image.fromarray(img)))
    got = tbp.build_processor(raw)({"img": img, "k": 1})
    ref = jbp.build_processor(ConfigDict(raw))({"img": img, "k": 1})
    assert got["k"] == ref["k"] == 1
    np.testing.assert_array_equal(got["img"], ref["img"])


@pytest.mark.parametrize("strong_aug", [False, True], ids=["shortest_edge", "strong_aug"])
@pytest.mark.parametrize("with_mask", [False, True], ids=["image", "mask"])
def test_loc_image_train_geometric_modes_equal_the_jax_one(strong_aug, with_mask):
    kw = dict(image_size=24, strong_aug=strong_aug, identity=False, seed=3)
    port, ref = tbp.LocImageTrainProcessor(**kw), jbp.LocImageTrainProcessor(**kw)
    for i, (h, w) in enumerate(((40, 57), (57, 40), (24, 30), (9, 13))):
        sample = {"img": _smooth(h, w, i), "tag": i}
        if with_mask:
            sample["gt_seg_map"] = (np.random.default_rng(i).random((h, w)) > 0.7).astype(
                np.float32)
        got, want = port(dict(sample)), ref(dict(sample))
        assert got["tag"] == want["tag"] == i
        np.testing.assert_array_equal(got["img"], want["img"])
        assert got["img"].shape == (24, 24, 3)
        if with_mask:
            assert got["gt_seg_map"].dtype == want["gt_seg_map"].dtype
            np.testing.assert_array_equal(got["gt_seg_map"], want["gt_seg_map"])
    cfg = {"name": "loc_image_train", "image_size": 24, "identity": False}
    assert not tbp.build_processor(cfg).identity


# -- the tar-shard stream --------------------------------------------------------
def _write_shard(path, n, caption, seed, start=0, extras=False):
    """``n`` samples: JPEGs (a few PNGs) with json captions, some with .txt,
    and, with ``extras``, a group without a caption and one without an image."""
    rng = np.random.default_rng(seed)
    with tarfile.open(path, "w") as tar:
        def add(name, data):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))

        for i in range(start, start + n):
            arr = _smooth(int(rng.integers(20, 60)), int(rng.integers(20, 60)), seed + i)
            if i % 5 == 4:
                add(f"{i:05d}.png", encode_png(arr))
            else:
                add(f"{i:05d}.jpg", _jpeg_bytes(arr, quality=int(rng.integers(60, 95))))
            if i % 3 == 2:
                add(f"{i:05d}.txt", f"{caption} {i}. Text!".encode())
            else:
                add(f"{i:05d}.json", json.dumps({"caption": f"{caption} #{i} (json)"}).encode())
        if extras:
            add("nocap.jpg", _jpeg_bytes(_smooth(8, 8, 0)))
            add("noimg.json", json.dumps({"caption": "orphan"}).encode())


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    _write_shard(str(root / "00000.tar"), 7, "a photo of a gadget", seed=1, extras=True)
    _write_shard(str(root / "00001.tar"), 5, "a bridge", seed=2, start=100)
    return str(root)


@pytest.mark.parametrize("buffer", [4, 1000], ids=["buffer_4", "buffer_1000"])
def test_tar_stream_equals_the_jax_stream(shards, buffer):
    def make(mod, proc_mod):
        return mod.TarShardIterableDataset(
            proc_mod.build_processor(ConfigDict({"name": "blip2_image_train",
                                                 "image_size": 28})),
            proc_mod.build_processor(ConfigDict({"name": "blip_caption"})),
            os.path.join(shards, "*.tar"), seed=5, shuffle_buffer=buffer)

    port, ref = iter(make(tcap, tbp)), iter(make(jcap, jbp))
    for _ in range(30):  # past both shards, through several resampled draws
        a, b = next(port), next(ref)
        assert a["text_input"] == b["text_input"]
        np.testing.assert_array_equal(a["image"], b["image"])


def test_tar_stream_takes_locations_as_the_jax_reader(shards, tmp_path):
    proc = tbp.BaseProcessor()
    ds = tcap.TarShardIterableDataset(proc, proc, shards)  # a directory: its *.tar
    assert ds.shards == sorted(os.path.join(shards, f) for f in ("00000.tar", "00001.tar"))
    brace = str(tmp_path / "{00000..01255}.tar")  # not expanded: the literal path
    ds = tcap.TarShardIterableDataset(proc, proc, brace)
    assert ds.shards == [brace]
    with pytest.raises(FileNotFoundError):
        next(iter(ds))
    with pytest.raises(FileNotFoundError):
        tcap.TarShardIterableDataset(proc, proc, str(tmp_path / "*.tar"))


# -- map-style datasets --------------------------------------------------------------
@pytest.fixture(scope="module")
def caption_tree(tmp_path_factory):
    """cc_sbu_align's layout (``image/``, ``filter_cap.json``), a Panda json and
    a two-class AD tree, each with JPEGs and PNGs."""
    root = str(tmp_path_factory.mktemp("captions"))
    anns = []
    for i in range(4):
        kind = "png" if i == 3 else "jpg"
        _write_image(os.path.join(root, "image", f"{i}.{kind}"), _smooth(30 + i, 41, i), kind)
        ann = {"image_id": str(i), "caption": f"A Picture (of thing {i})!"}
        if kind == "png":
            ann["image"] = f"{i}.png"
        anns.append(ann)
    with open(os.path.join(root, "filter_cap.json"), "w") as f:
        json.dump({"annotations": anns}, f)
    panda = []
    for i in range(3):
        kind = "jpg" if i else "png"
        _write_image(os.path.join(root, "panda", f"p{i}.{kind}"), _smooth(33, 29 + i, 10 + i),
                     kind)
        turn = ({"from": "human", "value": f"What is {i}?"}, {"from": "gpt", "value": f"It {i}."})
        panda.append({"image_name": f"p{i}.{kind}",
                      "conversation": list(turn) if i != 1 else [t["value"] for t in turn]})
    with open(os.path.join(root, "panda", "panda.json"), "w") as f:
        json.dump(panda, f)
    rows = []
    for i, (cls, kind) in enumerate((("bottle", "png"), ("cable", "jpg"), ("bottle", "jpg"))):
        rel = f"mvtec/{cls}/test/good/{i:03d}.{kind}"
        _write_image(os.path.join(root, "ad", rel), _smooth(50, 45, 20 + i), kind)
        rows.append({"img_path": rel, "is_anomaly": "1" if i == 1 else "0"})
    with open(os.path.join(root, "ad", "DC_MVTEC_test_normal.jsonl"), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    return root


def _same_item(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(b[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_caption_datasets_equal_the_jax_ones(caption_tree):
    vis = {"name": "blip2_image_train", "image_size": 28}
    txt = {"name": "blip_caption"}
    procs = lambda bp: (bp.build_processor(ConfigDict(vis)), bp.build_processor(ConfigDict(txt)))
    for t_cls, j_cls, root, anns in (
            (tcap.CCSBUAlignDataset, jcap.CCSBUAlignDataset, caption_tree,
             [os.path.join(caption_tree, "filter_cap.json")]),
            (tcap.CaptionDataset, jcap.CaptionDataset, caption_tree, ["filter_cap.json"]),
            (tcap.PandaInstructionDataset, jcap.PandaInstructionDataset,
             os.path.join(caption_tree, "panda"), ["panda.json"])):
        port = t_cls(*procs(tbp), vis_root=root, ann_paths=anns)
        ref = j_cls(*procs(jbp), vis_root=root, ann_paths=anns)
        assert len(port) == len(ref) > 0
        for i in range(len(ref)):
            _same_item(port[i], ref[i])


@pytest.mark.parametrize("is_preload", [False, True])
def test_two_class_dataset_equals_the_jax_one(caption_tree, is_preload):
    root = os.path.join(caption_tree, "ad")
    kw = dict(vis_root=root, ann_paths=["DC_MVTEC_test_normal.jsonl"], img_size=40,
              crop_size=32, is_preload=is_preload)
    port = tad.TwoClassAnomalyDetectionDataset(tbp.BaseProcessor(), tbp.BaseProcessor(), **kw)
    ref = jad.TwoClassAnomalyDetectionDataset(jbp.build_processor(None),
                                              jbp.build_processor(None), **kw)
    assert len(port) == len(ref) == 3
    for i in range(3):
        _same_item(port[i], ref[i])
    assert port[1]["is_anomaly"] and port[1]["text_input"] == tad.ABNORMAL_DESCRIBE
    assert tad.TWOCLS_INSTRUCTIONS == jad.TWOCLS_INSTRUCTIONS


def test_anomaly_dataset_reads_jpeg_as_the_jax_one(caption_tree):
    root = os.path.join(caption_tree, "ad")
    kw = dict(vis_root=root, ann_paths=["DC_MVTEC_test_normal.jsonl"], img_size=40,
              crop_size=32)
    port = tad.AnomalyDetectionDataset(**kw, vis_processor=tbp.build_processor(
        {"name": "loc_image_train", "identity": True}))
    ref = jad.AnomalyDetectionDataset(**kw, vis_processor=jbp.LocImageTrainProcessor(
        identity=True), text_processor=None)
    for i in range(3):
        np.testing.assert_array_equal(port[i]["image"], ref[i]["image"])


# -- loaders and builders --------------------------------------------------------------
def test_multi_iter_loader_and_batcher_equal_the_jax_ones(shards):
    class Counter:
        def __init__(self, tag):
            self.tag, self.n = tag, 0

        def __next__(self):
            self.n += 1
            return (self.tag, self.n)

    for ratios, seed in (([115.0, 14.0], 42), ([1.0, 2.0, 3.0], 0), (None, 7)):
        k = 2 if ratios is None else len(ratios)
        port = tloaders.MultiIterLoader([Counter(i) for i in range(k)], ratios, seed=seed)
        ref = jloaders.MultiIterLoader([Counter(i) for i in range(k)], ratios, seed=seed)
        got = [next(port) for _ in range(200)]
        assert got == [next(ref) for _ in range(200)]
        assert {tag for tag, _ in got} == set(range(k))
    # the stage-1 mix: the picks are default_rng(seed).choice(2, p=[115, 14] / 129)
    port = tloaders.MultiIterLoader([Counter(0), Counter(1)], [115.0, 14.0], seed=42)
    picks = [next(port)[0] for _ in range(50)]
    rng = np.random.default_rng(42)
    assert picks == [int(rng.choice(2, p=[115 / 129, 14 / 129])) for _ in range(50)]

    proc = dict(vis=ConfigDict({"name": "blip2_image_train", "image_size": 28}),
                txt=ConfigDict({"name": "blip_caption"}))

    def stream(mod, bp):
        return mod.TarShardIterableDataset(bp.build_processor(proc["vis"]),
                                           bp.build_processor(proc["txt"]),
                                           os.path.join(shards, "*.tar"), seed=1,
                                           shuffle_buffer=3)

    port = tloaders.IterableBatcher(stream(tcap, tbp), 5)
    ref = jloaders.IterableBatcher(stream(jcap, jbp), 5)
    for _ in range(4):
        _same_item(next(port), next(ref))


@pytest.mark.parametrize("name", ["laion", "cc_sbu", "cc_sbu_align", "panda",
                                  "two_class_anomaly_detection", "anomaly_detection"])
def test_builders_build_from_their_config(name, shards, caption_tree, tmp_path):
    from myriad_tpu_torch.common.config import Config

    storage = {"laion": os.path.join(shards, "*.tar"), "cc_sbu": shards,
               "cc_sbu_align": caption_tree, "panda": os.path.join(caption_tree, "panda"),
               "two_class_anomaly_detection": os.path.join(caption_tree, "ad"),
               "anomaly_detection": os.path.join(caption_tree, "ad")}[name]
    ann = {"panda": "panda.json", "two_class_anomaly_detection": "DC_MVTEC_test_normal.jsonl",
           "anomaly_detection": "DC_MVTEC_test_normal.jsonl"}.get(name)
    lines = ["datasets:", f"  {name}:", "    sample_ratio: 3", "    build_info:",
             f"      storage: {storage}"]
    if ann:
        lines += ["      ann_paths:", f"        - {ann}"]
    if name in ("two_class_anomaly_detection", "anomaly_detection"):
        lines += ["    img_size: 40", "    crop_size: 32", "    is_preload: False"]
    path = tmp_path / "cfg.yaml"
    path.write_text("\n".join(lines) + "\n")
    cfg = Config(cfg_path=str(path)).datasets_cfg[name]
    built = tbuilders.get_builder_class(name)(cfg).build_datasets()
    jbuilt = jbuilders.registry.get_builder_class(name)(cfg).build_datasets()
    assert sorted(built) == sorted(jbuilt) == ["train"]
    ds, jds = built["train"], jbuilt["train"]
    assert type(ds).__name__ == type(jds).__name__
    assert ds.sample_ratio == jds.sample_ratio == 3.0
    if hasattr(jds, "__len__"):
        assert len(ds) == len(jds) > 0
        if name != "anomaly_detection":  # NSA twins draw from unseeded generators
            _same_item(ds[0], jds[0])
    else:
        _same_item(next(iter(ds)), next(iter(jds)))
    with pytest.raises(NotImplementedError, match="coco"):
        tbuilders.get_builder_class("coco")
