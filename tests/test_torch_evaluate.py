"""The port's AQA evaluation (myriad_tpu_torch/evaluate.py) and the modules
under it against the JAX package and the libraries it calls, on the CPU.

- ``common/yaml_subset`` equals ``yaml.safe_load`` on every config YAML of
  the repository and on edge cases; YAML outside the subset raises.
- ``common/config.Config`` equals the JAX ``Config`` on
  ``eval_configs/myriad.yaml`` with and without ``--options``.
- ``datasets/anomaly_detection`` items equal the JAX dataset's at
  ``stage="test"`` (the float32 image bit-identical).
- ``evaluate.run`` on the ``pair`` fixture's port model writes the rows that
  the JAX harness's rule (``evaluation_aqa_dataset.py``, ``flush``) makes of
  the pair's JAX ``Myriad.generate`` on the JAX dataset's batches: every
  field identical, ``anomaly_score`` within 1e-4 (maps agree within 1e-5,
  and the fourth decimal may round either way).  One batch shape, so one
  JAX compile.
"""

import ast
import glob
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from fixtures import make_ad_dataset
from myriad_tpu_torch import evaluate
from myriad_tpu_torch.common import yaml_subset
from myriad_tpu_torch.common.config import Config, get_model_class
from myriad_tpu_torch.datasets.anomaly_detection import AnomalyDetectionDataset
from myriad_tpu_torch.datasets.loaders import DataLoader
from test_torch_myriad import pair  # noqa: F401  (the module's JAX/port model pair)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_YAMLS = sorted(
    os.path.relpath(p, REPO) for pattern in ("eval_configs/*.yaml", "train_configs/*.yaml",
                                             "myriad_tpu/configs/**/*.yaml")
    for p in glob.glob(os.path.join(REPO, pattern), recursive=True))
OPTIONS = ["model.llm_weight_dtype=int8", "model.llm_spec_k=3", "run.device=cpu"]
NEW_TOKENS = 90  # the harness default
BS = 4


@pytest.mark.parametrize("path", CONFIG_YAMLS)
def test_yaml_reader_equals_safe_load_on_the_configs(path):
    with open(os.path.join(REPO, path)) as f:
        ref = yaml.safe_load(f)
    assert yaml_subset.load_file(os.path.join(REPO, path)) == ref


EDGE_CASES = [
    "k: 'it''s'", 'k: "a\\tb \\u00e9\\x41"', "k: a  b", "k: -a", "k: a:b", "k: env://",
    "k: a#b", "k: a # comment", "k: 'a' # c", "k: \"#x\"", "k:   ", "k:", "e: ~", "k: null",
    "k: 1e-4", "k: 1.0e-4", "k: 1.5e4", "k: .5", "k: 1.", "k: +1", "k: -0", "k: 017",
    "k: 09", "k: 0x1F", "k: 0b101", "k: 1_000", "k: 190:20:30", "k: 1:2.5", "k: .inf",
    "k: True", "k: true", "k: on", "k: No", "k: y", "yes: no", "1: a", "k: None",
    "k: [a, b, ]", "k: []", 'k: ["train"]', "k: [a, [b, 'c d'], 3]", "k: [1.5, 1e-4, true, ~]",
    "k:\n- a\n- b", "k:\n  - a\n  - b", "a:\n  - x: 1\n    y: 2\n  - z", "- - a\n  - b\n- c",
    "a:\n  b:\n    c: 1\n  d: 2\ne: 3", "k:\n  v", " a: 1\n b: 2", "a: 1\na: 2",
    '"a: b": c', "# only a comment", "", "int8", "[1, 2]", "a: b", "k: /x/{00000..01255}.tar",
]


@pytest.mark.parametrize("text", EDGE_CASES)
def test_yaml_reader_equals_safe_load_on_edge_cases(text):
    ref = yaml.safe_load(text)
    got = yaml_subset.load(text)
    assert got == ref and type(got) is type(ref)
    if isinstance(ref, dict):
        assert [type(v) for v in got.values()] == [type(v) for v in ref.values()]


@pytest.mark.parametrize("text,what", [
    ("k: &a x", "anchor"), ("k: *a", "alias"), ("k: !!int 3", "tag"),
    ("k: |\n  x", "block scalar"), ("k: >\n  x", "block scalar"),
    ("k: {a: 1}", "flow mapping"), ("? a\n: b", "complex key"), ("k: <<", "merge key"),
    ("k: 2001-12-14", "timestamp"), ("---\nk: 1", "document markers"),
    ("a: 1\nk: [a,\n  b]", "line 2: a flow sequence over several lines"),
    ("k: 'a\n  b'", "quoted scalar over several lines"),
    ("a:\n  k: a\n    b", "line 3: a scalar over several lines"),
    ("a:\n  b: 1\n c: 2", "line 3: bad indentation"), ("k: a: b", "mapping value"),
])
def test_yaml_reader_refuses_outside_the_subset(text, what):
    with pytest.raises(yaml_subset.YAMLSubsetError, match=what):
        yaml_subset.load(text)


@pytest.mark.parametrize("options", [None, OPTIONS])
def test_config_equals_the_jax_config(options):
    import myriad_tpu.datasets  # noqa: F401  (registers the JAX builders)
    import myriad_tpu.models  # noqa: F401  (registers the JAX models)
    from myriad_tpu.common.config import Config as JaxConfig

    path = os.path.join(REPO, "eval_configs", "myriad.yaml")
    ours = Config(cfg_path=path, options=options).to_dict()
    assert ours == JaxConfig(cfg_path=path, options=options).to_dict()
    assert ours["model"]["llama_model"] == ""  # a default of the model's YAML
    if options:
        assert (ours["model"]["llm_spec_k"], ours["run"]["device"]) == (3, "cpu")


@pytest.mark.parametrize("raw", ["3", "1e-4", "0.5", "int8", "True", "[1, 2]", "a: b", "",
                                 "[1, 2", "null", "1_000", " 7"])
def test_option_values_parse_as_jax(raw):
    from myriad_tpu.common.config import parse_dotlist as jax_parse_dotlist
    from myriad_tpu_torch.common.config import parse_dotlist

    assert parse_dotlist([f"a.b={raw}"]) == jax_parse_dotlist([f"a.b={raw}"])


def test_default_yaml_copies_equal_the_originals():
    for rel in ("models/minigpt4.yaml", "datasets/anomaly_detection/base.yaml"):
        with open(os.path.join(REPO, "myriad_tpu", "configs", rel), "rb") as f:
            original = f.read()
        with open(os.path.join(REPO, "myriad_tpu_torch", "configs", rel), "rb") as f:
            assert f.read() == original, rel


def test_unknown_arch_and_dataset_raise_listing_the_known(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text("model:\n  arch: mini_gpt4\n")
    with pytest.raises(KeyError, match=r"Unknown model 'mini_gpt4'. Registered: \[myriad\]"):
        Config(cfg_path=str(path))
    path.write_text("datasets:\n  laion:\n    sample_ratio: 1\n")
    with pytest.raises(KeyError, match=r"Unknown builder 'laion'. Registered: "
                                       r"\[anomaly_detection\]"):
        Config(cfg_path=str(path))
    with pytest.raises(ValueError, match="key=value"):
        Config(cfg_path=str(path), options=["model.arch"])
    assert get_model_class("myriad").__module__ == "myriad_tpu_torch.models.myriad"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The synthetic MVTec tree: bottle and cable, 5 test images each."""
    root = str(tmp_path_factory.mktemp("ad"))
    make_ad_dataset(root, classes=("bottle", "cable"), n_test=5, img_size=28)
    return root


def _jax_dataset(root, img_size, crop_size):
    from myriad_tpu.datasets.anomaly_detection import AnomalyDetectionDataset as JaxDataset
    from myriad_tpu.processors.blip_processors import LocImageTrainProcessor

    return JaxDataset(LocImageTrainProcessor(identity=True), None, root,
                      ann_paths=["DC_MVTEC_test_normal.jsonl"], img_size=img_size,
                      crop_size=crop_size, is_preload=True, stage="test")


@pytest.mark.parametrize("img_size,crop_size", [(28, 28), (40, 28), (20, 28)])
def test_dataset_items_equal_jax(tree, img_size, crop_size):
    """Each item of the port's test set equals the JAX one's: the float32
    image bit-identical, every other field equal (28: no resize; 40: a
    downscale; 20: an upscale and a black border)."""
    ours = AnomalyDetectionDataset(tree, ann_paths=["DC_MVTEC_test_normal.jsonl"],
                                   img_size=img_size, crop_size=crop_size, is_preload=True)
    ref = _jax_dataset(tree, img_size, crop_size)
    assert len(ours) == len(ref) == 10
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert set(a) == set(b)
        assert a["image"].dtype == b["image"].dtype == np.float32
        np.testing.assert_array_equal(a["image"], b["image"])
        for k in b:
            if k != "image":
                assert a[k] == b[k], k


def test_loader_batches_equal_jax(tree):
    from myriad_tpu.datasets.loaders import DataLoader as JaxDataLoader

    ours = AnomalyDetectionDataset(tree, ann_paths=["DC_MVTEC_test_normal.jsonl"],
                                   img_size=28, crop_size=28)
    ref = _jax_dataset(tree, 28, 28)
    batches = list(DataLoader(ours, batch_size=BS, num_workers=2))
    ref_batches = list(JaxDataLoader(ref, batch_size=BS, num_workers=2))
    assert len(batches) == len(ref_batches) == 3 and len(batches[-1]["image_id"]) == 2
    for a, b in zip(batches, ref_batches):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_dataset_refuses_what_is_not_ported(tree):
    # the train stage is ported (tests/test_torch_train_data.py); other stages raise
    with pytest.raises(ValueError, match="stage='eval'"):
        AnomalyDetectionDataset(tree, stage="eval")
    with pytest.raises(NotImplementedError, match="with_mask"):
        AnomalyDetectionDataset(tree, ve_root=tree, with_mask=True)


def test_copied_tables_equal_the_originals():
    sys.path.insert(0, REPO)
    import evaluation_aqa_dataset as jax_eval
    from myriad_tpu.datasets import anomaly_detection as jad
    from myriad_tpu_torch.datasets import anomaly_detection as tad

    for name in ("LIVE_TASKS", "DEAD_TASKS", "ANNO_FILES"):
        assert getattr(evaluate, name) == getattr(jax_eval, name), name
    for name in ("QUESTION_PROMPTS", "NORMAL_DESCRIBE", "ABNORMAL_DESCRIBE"):
        assert getattr(tad, name) == getattr(jad, name), name


def _write_config(path, root, device="cpu"):
    run = f"run:\n  device: {device}\n" if device else ""
    path.write_text(
        "model:\n  arch: myriad\n  model_type: pretrain_vicuna\n  arch_preset: tiny\n"
        "  image_size: 28\n"
        f"datasets:\n  anomaly_detection:\n    img_size: 28\n    crop_size: 28\n"
        f"    build_info:\n      storage: {root}\n" + run)
    return str(path)


def _jax_bench_keys():
    """The keys of the JAX harness's --bench line and of its phase means."""
    with open(os.path.join(REPO, "evaluation_aqa_dataset.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    found = {}
    for node in ast.walk(main):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            name = getattr(node.targets[0], "id", None)
            if name in ("line", "phases"):
                found[name] = {k.value for k in node.value.keys}
    return found["line"], found["phases"]


def _jax_rows(jm, root):
    """The JAX harness's rows (evaluation_aqa_dataset.py: the ragged batch
    padded by repeating its last sample, ``flush``) from the JAX model's
    generate on the JAX dataset's batches."""
    from myriad_tpu.datasets.loaders import DataLoader as JaxDataLoader

    rows = []
    for samples in JaxDataLoader(_jax_dataset(root, 28, 28), batch_size=BS, num_workers=4):
        real_bs = len(samples["image_id"])
        for k, v in list(samples.items()):
            if isinstance(v, np.ndarray):
                samples[k] = np.concatenate([v, np.repeat(v[-1:], BS - real_bs, axis=0)])
            elif isinstance(v, list):
                samples[k] = v + [v[-1]] * (BS - real_bs)
        out = jm.generate(samples, max_new_tokens=NEW_TOKENS, do_sample=False, top_p=0.01,
                          temperature=1.0)
        token_ids = np.clip(np.asarray(out["token_ids"])[:real_bs], 1, 40000)
        maps = np.asarray(out["ve_anomaly_maps"])
        for ind, text in enumerate(jm.llama_tokenizer.batch_decode(token_ids)):
            text = text.split("###")[0]
            is_anomaly = bool(samples["is_anomaly"][ind])
            ok = ("Yes" in text and is_anomaly) or ("No" in text and not is_anomaly)
            rows.append({"image_id": int(samples["image_id"][ind]),
                         "image_path": "/".join(samples["img_path"][ind].split("/")[-5:]),
                         "is_anomaly": is_anomaly, "output": text,
                         "error": "0" if ok else "1",
                         "anomaly_score": str(round(float(maps[ind].max()), 4))})
    return rows


def test_eval_rows_match_jax(pair, tree, tmp_path, capsys):  # noqa: F811
    """``evaluate.run`` (main's body after the model is built) on the pair's
    port model, --bs 4 over 10 images (the last batch ragged), against the
    JAX harness's rule on the pair's JAX model."""
    jm, pm = pair
    save = tmp_path / "rows.jsonl"
    args = evaluate.parse_args(["--cfg-path", _write_config(tmp_path / "cfg.yaml", tree),
                                "--bs", str(BS), "--greedy", "--bench", "--max_new_tokens",
                                str(NEW_TOKENS), "--save_path", str(save)])
    out = evaluate.run(args, Config(args), pm)
    printed = capsys.readouterr().out
    assert pm.vision_expert.class_names == ["bottle", "cable"]
    with open(save) as f:
        written = [json.loads(line) for line in f]
    assert written == out["rows"]
    ref = _jax_rows(jm, tree)
    assert len(written) == len(ref) == 10
    assert [r["image_id"] for r in written] == list(range(10))
    for got, want in zip(written, ref):
        assert list(got) == list(want)
        for k in ("image_id", "image_path", "is_anomaly", "output", "error"):
            assert got[k] == want[k], (k, got, want)
        assert math.isclose(float(got["anomaly_score"]), float(want["anomaly_score"]),
                            abs_tol=1e-4), (got, want)
    assert sum(len(t) for t in out["token_ids"]) == 10
    assert any(t.max() > 2 for t in out["token_ids"])  # some bytes were decoded
    line_keys, phase_keys = _jax_bench_keys()
    bench = json.loads(printed.strip().splitlines()[-1])
    assert bench == out["bench"]
    assert set(bench) == line_keys and set(bench["phase_means_s"]) == phase_keys
    assert bench["batches"] == 2 and bench["batch_size"] == BS
    # batches 2-3 took at least their two generates (the tokens' ready times)
    assert 0 < bench["value"] <= BS / bench["phase_means_s"]["dispatch"] * 1.01
    assert "PyTorch port on CPU" in bench["metric"]
    assert "Device Memory: 0.0" in printed


def test_evaluate_refuses_what_is_not_ported(tree, tmp_path, capsys):
    cfg = _write_config(tmp_path / "cfg.yaml", tree)
    # --engine is served; the JAX engine's block KV layout is what is not
    # ported, and the engine runs with per-row frontiers instead
    out = evaluate.main(["--cfg-path", cfg, "--engine", "--engine-block", "8", "--bs", "2",
                         "--max_new_tokens", "4", "--save_path", str(tmp_path / "e.jsonl")])
    assert sorted(r["image_id"] for r in out["rows"]) == list(range(10))
    assert out["stats"]["completed"] == 10
    printed = capsys.readouterr().out
    assert "block KV layout (--engine-block 8) is not ported" in printed
    assert "(segment 32, block 0, spec 0)" in printed
    with pytest.raises(NotImplementedError, match="k_shot=1"):
        evaluate.setup_vision_expert(None, None, 1)
    with pytest.raises(SystemExit, match="task_type 'aqa'"):
        evaluate.build_dataset(evaluate.parse_args(["--cfg-path", cfg, "--task_type", "aqa"]),
                               {}, tree)
    with pytest.raises(NotImplementedError, match="ckpt='x/checkpoint_3'"):
        cfg_ckpt = tmp_path / "ckpt.yaml"
        cfg_ckpt.write_text(open(cfg).read().replace("arch_preset: tiny",
                                                     "arch_preset: tiny\n  ckpt: x/y.pth"))
        evaluate.main(["--cfg-path", str(cfg_ckpt), "--ckpt", "3"])


def test_evaluate_runs_on_the_card_by_default(tree, tmp_path):
    """``python -m myriad_tpu_torch.evaluate`` with no ``run.device`` goes to
    the card, and raises without one; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default would run")
    cfg = _write_config(tmp_path / "cfg.yaml", tree, device=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main(["--cfg-path", cfg])
    res = subprocess.run([sys.executable, "-m", "myriad_tpu_torch.evaluate", "--cfg-path",
                          os.path.join(REPO, "eval_configs", "myriad.yaml")], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0 and "no CUDA device" in res.stderr, res.stderr[-2000:]
