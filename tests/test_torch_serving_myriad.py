"""The port's Myriad front end for the engine
(myriad_tpu_torch/serving/myriad_adapter.py) against the JAX package's, and
``python -m myriad_tpu_torch.evaluate --engine``, on the CPU.

The ``pair`` fixture (tests/test_torch_myriad.py: tiny Myriad, int8 LLM
weights and KV, fp32, the same random weights on both sides) serves both
front ends with one schedule.  Gates: request ids, token ids, texts, scenes
and held flags equal (tolerance 0); ``anomaly_score`` within 1e-5, the
maps' tolerance (tests/test_torch_myriad.py).  The eval's ``--engine`` rows,
keyed by image id, equal the fixed-batch rows of the same model, and its
``--bench`` line has the JAX harness's keys.
"""

import ast
import json
import os

import numpy as np
import pytest

from myriad_tpu.serving.myriad_adapter import MyriadServing as JaxServing
from myriad_tpu_torch import evaluate
from myriad_tpu_torch.generation import trim_stop_ids
from myriad_tpu_torch.serving import MyriadServing
from test_torch_evaluate import _write_config, tree  # noqa: F401  (the synthetic MVTec tree)
from test_torch_myriad import QUESTION, pair  # noqa: F401  (the module's JAX/port pair)
from test_torch_serving import keep_jax_programs, share_jax_programs
import torch_threads  # noqa: F401  (one torch thread a test process)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(slots=2, segment=4, max_new_tokens=6, admit_widths=(160, 256), bucket=512)
Q2 = QUESTION.replace("defects", "anomalies")  # a second prompt length
_EMBED_PROGRAMS = {}  # the JAX front ends' embed compiles, one a prompt shape


def _jax_serving(jm, **kw):
    """A JAX front end that reuses the compiles of the earlier ones."""
    js = JaxServing(jm, **kw)
    js._embed_progs = _EMBED_PROGRAMS
    share_jax_programs(js.engine)
    return js


def _sample(seed, scene="bottle", question=QUESTION):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, size=(1, 28, 28, 3), dtype=np.uint8),
            "scene": [scene], "question2": [question],
            "img_path": [f"mvtec/{scene}/test/good/{seed:03d}.png"]}


def _same(got, want):
    """Rendered results of the two front ends, keyed by request id."""
    assert sorted(got) == sorted(want)
    for rid, w in want.items():
        g = got[rid]
        np.testing.assert_array_equal(g["token_ids"], np.asarray(w["token_ids"]))
        assert g["text"] == w["text"] and isinstance(g["text"], str)
        assert set(g) == set(w)
        assert (g["held"], g.get("scene")) == (w["held"], w.get("scene"))
        if "anomaly_score" in w:  # a continued turn has none
            assert abs(g["anomaly_score"] - w["anomaly_score"]) <= 1e-5


def _drain(jserving, tserving):
    want = {r["request_id"]: r for r in jserving.drain()}
    keep_jax_programs(jserving.engine)
    got = {r["request_id"]: r for r in tserving.drain()}
    _same(got, want)
    return got


@pytest.mark.parametrize("spec_k", [0, 2])
def test_adapter_matches_jax(pair, spec_k):  # noqa: F811
    """Three requests with two scenes and two prompt lengths over two slots,
    greedy and speculative (the lookup corpus installed from the first
    request); the port's transcripts also equal its own Myriad.generate."""
    jm, pm = pair
    samples = [_sample(0), _sample(1, "cable", Q2), _sample(2)]
    js, ts = _jax_serving(jm, spec_k=spec_k, **KW), MyriadServing(pm, spec_k=spec_k, **KW)
    ids = [js.submit(s) for s in samples]
    assert [ts.submit(s) for s in samples] == ids
    got = _drain(js, ts)
    for key in ("completed", "ticks", "decode_steps", "live_row_steps", "spec_accepted",
                "spec_drafted"):
        assert ts.stats[key] == js.stats[key], key
    assert ts.stats["completed"] == 3
    if spec_k:
        assert ts.stats["spec_drafted"] > 0
    for rid, s in zip(ids, samples):
        ref = pm.generate(s, max_new_tokens=6)["token_ids"][0].numpy()
        np.testing.assert_array_equal(got[rid]["token_ids"], trim_stop_ids(ref, ts.cfg))


@pytest.mark.parametrize("lazy", [False, True])
def test_adapter_submit_batch_matches_jax(pair, lazy):  # noqa: F811
    """submit_batch: runs of one question share one embed forward (groups of
    at most two here); lazy=True keeps groups on the host until the engine
    can admit them, the ids reserved at once."""
    jm, pm = pair
    samples = [_sample(20), _sample(21, "cable"), _sample(22, question=Q2),
               _sample(23, question=Q2), _sample(24, "cable"), _sample(25)]
    js, ts = _jax_serving(jm, **KW), MyriadServing(pm, **KW)
    ids = js.submit_batch(samples, max_group=2, lazy=lazy)
    assert ts.submit_batch(samples, max_group=2, lazy=lazy) == ids
    if lazy:
        assert ts._host_queue, "a burst should not embed everything at once"
        assert ts.engine.queued_rows <= ts.engine.free_slot_count + 2
        assert ts.pending == js.pending == len(samples)
    _drain(js, ts)
    assert not ts._host_queue and not ts._group_scores


def test_adapter_multi_turn_chat_matches_jax(pair):  # noqa: F811
    """Held conversations with text turns: the second turn's delta is only
    the turn's tokens, prefilled at the resident frontier; the scene is
    inherited."""
    jm, pm = pair
    js, ts = _jax_serving(jm, **KW), MyriadServing(pm, **KW)
    handles = [ts.submit_held(_sample(11)), ts.submit_held(_sample(12, "cable"))]
    assert [js.submit_held(_sample(11)), js.submit_held(_sample(12, "cable"))] == handles
    got = _drain(js, ts)
    assert all(r["held"] for r in got.values())
    turn = "###Human: does the defect affect function?###Assistant: "
    t_ids = [ts.continue_request(h, turn, hold=False) for h in handles]
    assert [js.continue_request(h, turn, hold=False) for h in handles] == t_ids
    second = _drain(js, ts)
    assert sorted(second) == sorted(t_ids) and not any(r["held"] for r in second.values())
    assert second[t_ids[1]]["scene"] == "cable"
    with pytest.raises(ValueError, match="single-image"):
        ts.submit_held({**_sample(13), "image": np.zeros((2, 28, 28, 3), np.uint8)})


def _jax_engine_bench_keys():
    """The keys of the JAX harness's engine --bench line (``run_engine_eval``)."""
    with open(os.path.join(REPO, "evaluation_aqa_dataset.py")) as f:
        module = ast.parse(f.read())
    fn = next(n for n in module.body
              if isinstance(n, ast.FunctionDef) and n.name == "run_engine_eval")
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "line":
            return {k.value for k in node.value.keys}
    raise AssertionError("no line dict in run_engine_eval")


def test_evaluate_engine_rows_equal_the_fixed_batch_rows(tree, tmp_path, capsys):  # noqa: F811
    """``python -m myriad_tpu_torch.evaluate --engine`` in process, --bs 2 over
    ten images: the rows, keyed by image id, equal the fixed-batch eval's of
    the same configuration and seed, written in order of completion."""
    cfg = _write_config(tmp_path / "cfg.yaml", tree)
    common = ["--cfg-path", cfg, "--bs", "2", "--greedy", "--bench", "--max_new_tokens", "12"]
    fixed = evaluate.main(common + ["--save_path", str(tmp_path / "fixed.jsonl")])
    capsys.readouterr()
    out = evaluate.main(common + ["--engine", "--engine-segment", "4",
                                  "--save_path", str(tmp_path / "engine.jsonl")])
    printed = capsys.readouterr().out
    with open(tmp_path / "engine.jsonl") as f:
        written = [json.loads(line) for line in f]
    assert written == out["rows"]
    assert sorted(r["image_id"] for r in written) == list(range(10))
    by_id = {r["image_id"]: r for r in fixed["rows"]}
    for row in written:
        assert row == by_id[row["image_id"]], row
    assert any(row["output"] for row in written)  # some bytes were decoded
    assert "block KV layout (--engine-block 8) is not ported" in printed
    assert "engine eval: 10 requests over 2 slots (segment 4, block 0, spec 0)" in printed
    bench = json.loads(printed.strip().splitlines()[-1])
    assert bench == out["bench"] and set(bench) == _jax_engine_bench_keys()
    assert (bench["requests"], bench["slots"]) == (10, 2)
    assert bench["ticks"] == out["stats"]["ticks"] > 0 and 0 < bench["slot_occupancy"] <= 1
    assert "PyTorch port on CPU" in bench["metric"]
