"""The port's vision-expert family against the JAX package's, on the CPU in fp32.

- ``ClipBpeTokenizer``: ids identical to the JAX one's for every MVTec and
  VisA class's prompt ensemble, over a merges file the test writes (BPE
  merges learnt from the prompts, padded to CLIP's 48,894, then merges past
  the cut).
- One-shot maps and masks within 1e-5, the reference bank's layout and
  padding equal (a class without images, a shorter class, a class whose real
  cosines are all negative).
- ``PrecomputedMaskExpert`` and the dataset's ``prepare_ve`` equal the JAX
  ones (OpenCV) within 1e-6; the PNG reader's gray image equals
  ``cv2.imread(IMREAD_GRAYSCALE)`` exactly.
- F9: ``Myriad.from_config`` reads the expert's keys (``vis_expert``,
  ``vis_expert_args``, ``clip_bpe_path``, ``init_vision_expert``,
  ``use_ve``, ``k_shot``) as the JAX one does: the same expert kind, maps
  (1e-5; SimpleNet 1e-4) and token ids, or the same exception type.
- ``k_shot = 1``: ``generate``'s tokens identical to the JAX fused one-shot
  generate on the ``pair`` fixture, and ``evaluate --k_shot 1`` rows equal
  to the JAX harness's rule (its ``setup_vision_expert`` builds the JAX bank);
  ``--engine`` serves the same rows.

The JAX models of the F9 cases are built by the JAX ``from_config`` with the
pair's parameters in place of an initialisation, and share the pair's
compiled programs.
"""

import gzip
import json
import math
import os
import sys
from collections import Counter

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import make_ad_dataset
from myriad_tpu import checkpoint as jax_ckpt
from myriad_tpu.models import clip_tokenizer as jtok
from myriad_tpu.models import simplenet as jsn
from myriad_tpu.models import vision_expert as jve
from myriad_tpu.models import vision_experts as jvx
from myriad_tpu.models.myriad import Myriad as JaxMyriad
from myriad_tpu_torch import evaluate
from myriad_tpu_torch.common.config import Config
from myriad_tpu_torch.convert_from_jax import state_dict_from_jax
from myriad_tpu_torch.datasets.anomaly_detection import AnomalyDetectionDataset
from myriad_tpu_torch.datasets.png import encode_png, read_png_gray
from myriad_tpu_torch.models import clip_tokenizer as ttok
from myriad_tpu_torch.models import vision_expert as tve
from myriad_tpu_torch.models import vision_experts as tvx
from myriad_tpu_torch.models.myriad import Myriad
from test_torch_evaluate import BS, NEW_TOKENS, _jax_rows, _write_config
from test_torch_myriad import SCENES, pair  # noqa: F401  (the module's JAX/port pair)
from test_torch_simplenet import _fill
import torch_threads  # noqa: F401  (one torch thread a test process)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUESTION = "<Img><ImageHere></Img>find out if there are defects in this image."
GEN_KW = dict(max_new_tokens=10, cache_granularity=16, stop_single=5, stop_pair=(7, 9))
TINY = {"arch_preset": "tiny", "llm_weight_dtype": "int8", "llm_kv_dtype": "int8",
        "param_policy": "fp32"}
N_MERGES = 49152 - 256 - 2  # the merges CLIP's tokenizer reads
SHOT_TOKENS = 32  # the one-shot eval's decode (test_evaluate_k_shot_rows_match_jax)


def _prompt_words():
    words = []
    for cls in jve.MVTEC_CLASS_NAMES + jve.VISA_CLASS_NAMES:
        normal, abnormal = jve.prompt_sentences_for(cls)
        for s in normal + abnormal:
            words += s.lower().replace(".", " .").split()
    return words


def write_merges(path, learnt=100, past_cut=40):
    """A CLIP-style merges file: byte-pair merges learnt from the prompt
    ensembles, filler merges up to CLIP's cut, then merges past the cut."""
    vocab = Counter(tuple(w[:-1]) + (w[-1] + "</w>",) for w in _prompt_words())
    merges = []
    for _ in range(learnt + past_cut):
        pairs = Counter()
        for word, n in vocab.items():
            for a, b in zip(word, word[1:]):
                pairs[a, b] += n
        if not pairs:
            break
        best = max(pairs, key=lambda p: (pairs[p], p))
        merges.append(best)
        new = Counter()
        for word, n in vocab.items():
            out, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    out.append(word[i] + word[i + 1])
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            new[tuple(out)] += n
        vocab = new
    assert len(merges) == learnt + past_cut
    filler = [(f"{i}", "zq") for i in range(N_MERGES - learnt)]
    lines = ["#version: 0.2"] + [" ".join(m) for m in merges[:learnt] + filler
                                 + merges[learnt:]]
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def bpe_path(tmp_path_factory):
    return write_merges(tmp_path_factory.mktemp("bpe") / "bpe_simple_vocab_16e6.txt.gz")


def test_clip_bpe_ids_equal_jax(bpe_path):
    ours, ref = ttok.ClipBpeTokenizer(bpe_path), jtok.ClipBpeTokenizer(bpe_path)
    assert (ours.sot, ours.eot) == (ref.sot, ref.eot) == (49406, 49407)
    assert ours.encoder == ref.encoder and ours.bpe_ranks == ref.bpe_ranks
    merged = 0
    for cls in jve.MVTEC_CLASS_NAMES + jve.VISA_CLASS_NAMES:
        normal, abnormal = tve.prompt_sentences_for(cls)
        for s in normal + abnormal:
            ids = ours.encode(s, 77)
            assert ids == ref.encode(s, 77), s
            assert ours.decode(ids) == ref.decode(ids)
            merged += ids.index(ours.eot) - 1 < len(s)
    assert merged > 0  # the learnt merges apply
    for s in ("A &amp; B\t  c", "naïve 漢字 ✓", "x" * 200, ""):
        assert ours.encode(s, 77) == ref.encode(s, 77)
    assert ttok.bytes_to_unicode() == jtok.bytes_to_unicode()


def _masked_tree(root):
    """Mask PNGs under ``root`` for the paths of ``MASK_PATHS``: gray, gray
    and alpha, RGB, RGBA, a palette, an exact halving and an odd size."""
    rng = np.random.default_rng(5)
    files = {
        "mvtec/bottle/test/good/000": encode_png(rng.integers(0, 256, (100, 100), np.uint8)),
        "mvtec/bottle/test/good/001": encode_png(rng.integers(0, 256, (448, 448), np.uint8),
                                                 filters=3),
        "mvtec/cable/test/broken/002": encode_png(rng.integers(0, 256, (53, 37, 3), np.uint8)),
        "mvtec/cable/test/broken/003": encode_png(rng.integers(0, 256, (64, 64, 4), np.uint8)),
        "mvtec/cable/test/good/004": encode_png(rng.integers(0, 256, (64, 64, 2), np.uint8)),
        "mvtec/cable/test/good/005": encode_png(
            rng.integers(0, 7, (30, 30), np.uint8), color_type=3,
            palette=rng.integers(0, 256, (7, 3), np.uint8)),
    }
    for rel, data in files.items():
        os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
        with open(os.path.join(root, rel + ".png"), "wb") as f:
            f.write(data)
    return [rel + ".jpg" for rel in files] + ["mvtec/cable/test/good/missing.png"]


def test_precomputed_masks_equal_opencv(tmp_path):
    paths = _masked_tree(str(tmp_path))
    for rel in paths[:-1]:
        full = os.path.join(tmp_path, os.path.splitext(rel)[0] + ".png")
        np.testing.assert_array_equal(read_png_gray(full), cv2.imread(full, cv2.IMREAD_GRAYSCALE))
    ref_maps, ref_masks = jvx.PrecomputedMaskExpert(str(tmp_path))(paths)
    maps, masks = tvx.PrecomputedMaskExpert(str(tmp_path), device="cpu")(paths)
    assert maps.shape == (len(paths), 224, 224, 1) and masks.shape == (len(paths), 16, 16, 1)
    np.testing.assert_allclose(maps.numpy(), np.asarray(ref_maps), rtol=0, atol=1e-6)
    np.testing.assert_allclose(masks.numpy(), np.asarray(ref_masks), rtol=0, atol=1e-6)
    assert float(maps[-1].abs().max()) == 0.0  # a missing file gives zeros


def test_prepare_ve_equals_jax(tmp_path):
    from myriad_tpu.datasets.anomaly_detection import AnomalyDetectionDataset as JaxDataset
    from myriad_tpu.processors.blip_processors import LocImageTrainProcessor

    root, ve_root = str(tmp_path / "ad"), str(tmp_path / "ve")
    make_ad_dataset(root, classes=("bottle", "cable"), n_train=0, n_test=4, img_size=28)
    with open(os.path.join(root, "DC_MVTEC_test_normal.jsonl")) as f:
        anns = [json.loads(line) for line in f]
    rng = np.random.default_rng(6)
    for ann in anns[:-1]:  # the last image has no mask
        path = os.path.join(ve_root, os.path.splitext(ann["img_path"])[0] + ".png")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(encode_png(rng.integers(0, 256, (90, 70), np.uint8)))
    kw = dict(ann_paths=["DC_MVTEC_test_normal.jsonl"], img_size=28, crop_size=28,
              with_mask=True, stage="test")
    ours = AnomalyDetectionDataset(root, ve_root=ve_root, **kw)
    ref = JaxDataset(LocImageTrainProcessor(identity=True), None, root, ve_root=ve_root, **kw)
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert set(a) == set(b)
        assert ("masks" in a) == (i < len(anns) - 1)
        if "masks" in a:
            assert a["masks"].shape == (28, 28, 1)
            np.testing.assert_allclose(a["masks"], b["masks"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(ours.prepare_ve(i) if i < len(anns) - 1 else 0,
                                   ref.prepare_ve(i) if i < len(anns) - 1 else 0,
                                   rtol=0, atol=1e-6)
    assert ours.prepare_ve(len(anns) - 1) is None


def _images(n, seed, size=28):
    rng = np.random.default_rng(seed)
    return ((rng.random((n, size, size, 3)) - 0.45) / 0.27).astype(np.float32)


def test_reference_bank_and_one_shot_match_jax(pair):  # noqa: F811
    """Bank per tap (C, max K * P, D): bottle 2 images, cable 1 (zero-padded),
    candle none (a zero bank: every cosine 0); pcb1's rows point away from
    every query token (every real cosine negative, so the max is the padding's
    0 on both sides)."""
    jm, pm = pair
    classes = ["bottle", "cable", "candle", "pcb1"]
    ref = jve.VisionExpert(jm.vision_expert.module, jm.vision_expert.params,
                           class_names=classes)
    ours = tve.VisionExpert(pm.vision_expert.module, class_names=classes)
    refs = {"bottle": _images(2, 1), "cable": _images(1, 2), "pcb1": _images(2, 3)}
    ref.build_reference_bank(refs)
    ours.build_reference_bank(refs)
    p = (28 // 14) ** 2
    for a, b in zip(ours._ref_bank, ref._ref_bank):
        assert tuple(a.shape) == tuple(b.shape) == (4, 2 * p, a.shape[-1])
        b = np.asarray(b)  # raw trunk tokens: the tolerance scales with their size
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5 * np.abs(b).max())
        assert float(a[1, p:].abs().max()) == float(a[2].abs().max()) == 0.0
    query = _images(4, 4)
    with torch.no_grad():
        q_tokens = pm.vision_expert.module.patch_tokens(torch.from_numpy(query))
    for tap, q in enumerate(q_tokens):
        qn = q / q.norm(dim=-1, keepdim=True)
        away = -qn.reshape(-1, qn.shape[-1]).mean(0)
        assert float((qn @ away).max()) < 0  # every real cosine negative
        rows = torch.zeros((2 * p, away.shape[0]))
        rows[0], rows[1] = away, 2 * away
        ours._ref_bank[tap] = torch.cat([ours._ref_bank[tap][:3], rows[None]])
        ref._ref_bank[tap] = ref._ref_bank[tap].at[3].set(jnp.asarray(rows.numpy()))
    scenes = ["bottle", "cable", "candle", "pcb1"]
    maps, masks = ours(torch.from_numpy(query), scenes, one_shot=True)
    ref_maps, ref_masks = ref(jnp.asarray(query), scenes, one_shot=True)
    assert maps.shape == (4, 224, 224, 1) and masks.shape == (4, 2, 2, 1)
    np.testing.assert_allclose(maps.numpy(), np.asarray(ref_maps), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(masks.numpy(), np.asarray(ref_masks), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(masks[2:].numpy(), 1.0, atol=1e-6)  # zero bank, negatives: max 0
    with pytest.raises(ValueError, match="build_reference_bank"):
        tve.VisionExpert(pm.vision_expert.module, class_names=classes)(
            torch.from_numpy(query), scenes, one_shot=True)


def _kind(expert):
    return None if expert is None else type(expert).__name__


@pytest.fixture(scope="module")
def f9_files(tmp_path_factory, bpe_path):
    """Files the F9 configurations name: SimpleNet heads and backbone (written
    by the JAX ``save_params``) and a mask tree for the F9 samples' paths."""
    root = tmp_path_factory.mktemp("f9")
    rng = np.random.default_rng(8)
    emb, head = jsn.SimpleNetEmbedder(), jsn.SimpleHead()
    emb_p = _fill(jax.eval_shape(lambda r: emb.init(r, jnp.zeros((1, 28, 28, 3))),
                                 jax.random.PRNGKey(0)), rng)
    jax_ckpt.save_params(str(root / "backbone.npz"), emb_p["params"]["backbone"])
    for cls in SCENES:
        p = _fill(jax.eval_shape(lambda r: head.init(r, jnp.zeros((1, 1536))),
                                 jax.random.PRNGKey(1)), rng)
        jax_ckpt.save_params(str(root / "heads" / f"{cls}.npz"), p["params"])
    ve_root = root / "ve"
    os.makedirs(ve_root / "mvtec" / "bottle")
    with open(ve_root / "mvtec" / "bottle" / "000.png", "wb") as f:
        f.write(encode_png(rng.integers(0, 256, (60, 60), np.uint8)))
    return {"bpe": bpe_path, "heads": str(root / "heads"), "backbone": str(root / "backbone.npz"),
            "ve_root": str(ve_root)}


F9 = {
    "adrefexpert": {"vis_expert": "adrefexpert"},
    "patchcore": {"vis_expert": "patchcore"},
    "adgpt": {"vis_expert": "adgpt"},
    "simplenet": {"vis_expert": "simplenet",
                  "vis_expert_args": {"ckpt_root": "{heads}", "backbone": "{backbone}"}},
    "aprilgan": {"vis_expert": "aprilgan", "vis_expert_args": {"ve_root": "{ve_root}"}},
    "unknown_expert": {"vis_expert": "nosuch"},
    "clip_bpe_path": {"clip_bpe_path": "{bpe}"},
    "clip_bpe_path_missing": {"clip_bpe_path": "/nonexistent/bpe_simple_vocab_16e6.txt.gz"},
    "init_vision_expert_false": {"init_vision_expert": False},
    "use_ve_false": {"use_ve": False},
    "k_shot_1": {"k_shot": 1},
}


def _resolve(value, files):
    if isinstance(value, dict):
        return {k: _resolve(v, files) for k, v in value.items()}
    return value.format(**files) if isinstance(value, str) else value


@pytest.mark.parametrize("case", list(F9))
def test_from_config_vision_expert_keys_as_jax(pair, f9_files, case):  # noqa: F811
    """F9: each configuration builds, on the port, the JAX side's expert
    kind and gives its maps and token ids, or raises its exception type."""
    jm, pm = pair
    cfg = {**TINY, **_resolve(F9[case], f9_files)}

    class PairInit(JaxMyriad):
        """The JAX Myriad with the pair's parameters for an initialisation."""

        def _init_params(self, rng):
            return jax.tree_util.tree_map(np.asarray, jm.params)

        def _init_ve_params(self, ve_module, rng):
            return jm.vision_expert.params

    try:
        ref_model = PairInit.from_config(dict(cfg))
    except Exception as e:  # the port raises the same type
        with pytest.raises(type(e)):
            Myriad.from_config(dict(cfg), device="cpu", class_names=SCENES)
        return
    ours = Myriad.from_config(dict(cfg), device="cpu", class_names=SCENES)
    ref_model._jit_cache = jm._jit_cache  # the pair's arch: its compiled programs serve
    assert _kind(ours.expert) == _kind(ref_model.expert)
    assert (ours.vision_expert is None) == (ref_model.vision_expert is None)
    assert ours.k_shot == ref_model.k_shot
    ve_state = None
    if ours.vision_expert is not None:
        tok, ref_tok = ours.vision_expert.tokenizer, ref_model.vision_expert.tokenizer
        assert type(tok).__name__ == type(ref_tok).__name__
        for s in sum(tve.prompt_sentences_for("metal_nut"), []):
            assert tok.encode(s, 77) == ref_tok.encode(s, 77)
        if case == "clip_bpe_path":
            # CLIP's ids (sot 49406) lie past the tiny text tower's 64-row
            # table: the full-width tower reads them, the tiny one cannot
            # (the port raises, the JAX gather fills NaN), so the maps and
            # tokens of this case are not compared
            return
        ve_state = pm.vision_expert.module.state_dict()
        ref_model.vision_expert.class_names = SCENES
        ref_model.vision_expert.class_index = {c: i for i, c in enumerate(SCENES)}
        ref_model.vision_expert.build_text_features()
    ours.load_state_dicts(state_dict_from_jax(jm.params), ve_state)
    samples = {"image": _images(2, 9), "scene": list(SCENES), "question2": [QUESTION] * 2,
               "img_path": ["mvtec/bottle/000.jpg", "mvtec/cable/001.jpg"]}
    ref = ref_model.generate(dict(samples), **GEN_KW)
    out = ours.generate(dict(samples), **GEN_KW)
    tol = 1e-4 if case == "simplenet" else 1e-5
    ref_maps = np.asarray(ref["ve_anomaly_maps"])
    np.testing.assert_allclose(out["ve_anomaly_maps"].numpy(), ref_maps, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(ref_maps).max())))
    if case == "simplenet":
        # the JAX pooling takes means as differences of cumulative sums over
        # 9,216 features, which rounds them (~4e-6) where the port takes
        # them exactly; with the last bits of two convolution libraries that
        # is ~3e-5 of a map, and the tiny random LLM's greedy argmax is not
        # stable under that.  The JAX model's tokens are taken on the
        # port's maps instead, through its own muxed-expert path.
        port_maps = jnp.asarray(out["ve_anomaly_maps"].numpy())
        ref_model.expert = lambda images, scenes: (port_maps, None)
        ref = ref_model.generate(dict(samples), **GEN_KW)
    np.testing.assert_array_equal(out["token_ids"].numpy(), np.asarray(ref["token_ids"]))
    if ours.expert is None:
        assert float(np.abs(ref_maps).max()) == 0.0
    if case == "aprilgan":
        assert float(ref_maps[0].max()) > 0 and float(np.abs(ref_maps[1]).max()) == 0.0


@pytest.fixture(scope="module")
def shot_tree(tmp_path_factory):
    """A 40-pixel MVTec tree with train/good (bottle 2 images, cable 1), cut to
    28 by the dataset and by the reference preprocessing."""
    root = str(tmp_path_factory.mktemp("shot"))
    make_ad_dataset(root, classes=("bottle", "cable"), n_train=2, n_test=5, img_size=40)
    os.remove(os.path.join(root, "mvtec", "cable", "train", "good", "001.png"))
    return root


@pytest.fixture(scope="module")
def one_shot_pair(pair, shot_tree):  # noqa: F811
    """The pair with k_shot 1 and each harness's bank of the tree (round 14:
    MVTec's names 056-059 are missing, so the sorted listing's first)."""
    sys.path.insert(0, REPO)
    import evaluation_aqa_dataset as jax_eval
    from test_torch_evaluate import _jax_dataset

    jm, pm = pair
    jm.k_shot = pm.k_shot = 1
    jax_eval.setup_vision_expert(jm, _jax_dataset(shot_tree, 28, 28), shot_tree, 14, 1)
    dataset = evaluate.build_dataset(evaluate.parse_args(["--cfg-path", "x"]),
                                     {"anomaly_detection": {"img_size": 28, "crop_size": 28}},
                                     shot_tree)
    evaluate.setup_vision_expert(pm, dataset, shot_tree, 14, 1)
    return jm, pm, dataset


def test_one_shot_bank_and_generate_match_jax(one_shot_pair):
    jm, pm, dataset = one_shot_pair
    for a, b in zip(pm.vision_expert._ref_bank, jm.vision_expert._ref_bank):
        assert tuple(a.shape) == tuple(b.shape) == (2, 4, a.shape[-1])
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5 * np.abs(b).max())
    refs = evaluate.load_reference_images(
        [os.path.join(dataset.vis_root, "mvtec", "bottle", "train", "good", "000.png")], 28)
    assert refs.shape == (1, 28, 28, 3) and refs.dtype == np.float32
    batch = {k: ([dataset[i][k] for i in range(BS)] if k != "image"
                 else np.stack([dataset[i][k] for i in range(BS)]))
             for k in ("image", "scene", "question2", "img_path")}
    kw = dict(max_new_tokens=NEW_TOKENS, do_sample=False, top_p=0.01, temperature=1.0)
    ref = jm.generate(dict(batch), **kw)
    out = pm.generate(dict(batch), **kw)
    np.testing.assert_array_equal(out["token_ids"].numpy(), np.asarray(ref["token_ids"]))
    np.testing.assert_allclose(out["ve_anomaly_maps"].numpy(), np.asarray(ref["ve_anomaly_maps"]),
                               rtol=1e-5, atol=1e-5)
    _, _, _, zero, one = pm.prepare_sample(dict(batch), 1)
    torch.testing.assert_close(one, out["ve_anomaly_maps"], rtol=0, atol=0)
    assert float((one - zero).abs().max()) > 1e-3  # one-shot maps are not the zero-shot ones


def test_evaluate_k_shot_rows_match_jax(one_shot_pair, shot_tree, tmp_path):
    """``evaluate.run --k_shot 1`` on the pair's port model against the JAX
    harness's rule on the pair's JAX model; then ``--engine`` gives the same
    rows.  Each batch's one-shot maps, the port's and the JAX bank's, agree
    within 1e-5, and the JAX model decodes from the port's: the tiny random
    model is chaotic on this tree (measured on the JAX side alone: its own
    maps and the port's, 2.4e-7 apart, give another byte after 17 tokens on
    one image; on the same maps the two sides part after ~60 tokens on
    another, as zero-shot generate does too), so the rows hold 32 tokens."""
    jm, pm, _ = one_shot_pair
    cfg = _write_config(tmp_path / "cfg.yaml", shot_tree)
    argv = ["--cfg-path", cfg, "--bs", str(BS), "--greedy", "--k_shot", "1",
            "--max_new_tokens", str(SHOT_TOKENS)]
    args = evaluate.parse_args(argv + ["--save_path", str(tmp_path / "rows.jsonl")])
    out = evaluate.run(args, Config(args), pm)

    def port_maps(images, scenes):
        ours, _ = pm.vision_expert(torch.from_numpy(np.asarray(images)), scenes, one_shot=True)
        own, _ = jm.vision_expert(images, scenes, one_shot=True)
        np.testing.assert_allclose(ours.numpy(), np.asarray(own), rtol=1e-5, atol=1e-5)
        return jnp.asarray(ours.numpy()), None

    jm.expert = port_maps
    try:
        ref = _jax_rows(jm, shot_tree, SHOT_TOKENS)
    finally:
        jm.expert = jm.vision_expert
    assert len(out["rows"]) == len(ref) == 10
    for got, want in zip(out["rows"], ref):
        for k in ("image_id", "image_path", "is_anomaly", "output", "error"):
            assert got[k] == want[k], (k, got, want)
        assert math.isclose(float(got["anomaly_score"]), float(want["anomaly_score"]),
                            abs_tol=1e-4), (got, want)
    # the engine admits with the one-shot maps (the anomaly scores are their
    # maxima); its rows equal the fixed batches' over the serving tests' 12
    # tokens (its per-row cache is another arithmetic past that)
    short = argv[:-1] + ["12"]
    rows = {}
    for mode in ([], ["--engine", "--engine-segment", "4"]):
        args = evaluate.parse_args(short + mode + ["--save_path", str(tmp_path / "s.jsonl")])
        rows[bool(mode)] = {r["image_id"]: r for r in evaluate.run(args, Config(args), pm)["rows"]}
    assert rows[True] == rows[False]
    for row in out["rows"]:
        assert rows[True][row["image_id"]]["anomaly_score"] == row["anomaly_score"]
    assert "kshot=1_roundindex=14" in evaluate._save_path(
        evaluate.parse_args(argv), Config(evaluate.parse_args(argv)))
