"""The port's Orbax checkpoint directories against orbax, tensorstore and
libzstd on the CPU, and its runner's checkpoints and validation against the
JAX runner's.

* The zstd decoder (``csrc/zstd_decode.cpp``): tensorstore's zarr chunks at
  levels 1, 3, 9 and 19 over fp32 N(0, 0.02) weights, zeros, an int8 ramp
  and repeated text decode bit-exact; a header walker lists the block,
  literal and sequence modes the frames use, every one decoded.  libzstd's
  frames with checksums hold XXH64 (and the spec's empty-input vector); a
  truncated frame, a flipped byte and a dictionary id raise.
* The OCDBT reader: the same keys and values as ``ts.KvStore`` on a
  JAX-written ring and on a database of many small nodes.
* ``restore``: the tree, dtypes and values of ``ocp.StandardCheckpointer()
  .restore`` on the JAX ``CheckpointManager``'s states (``accum_grad_iters``
  1 and 2, ``max_grad_norm``, bf16 ``mu``) and on the plain layout; the
  committed fixture (``tests/orbax_fixture``) regenerated from its seed and
  held to ``expected.json`` by orbax and by the port.
* The runner: deviation D3 (the JAX resume's leaf-order restore of
  ``MultiSteps``); ``valid_splits``, the best checkpoint and ``evaluate:
  True`` against the JAX runner's loop.  The port's ring resumed by the JAX
  runner and a JAX ring resumed by the port, on the tiny Myriad, are in
  ``tests/test_torch_train.py``, which compiles the JAX step once for them
  and its own parity test.
"""

import hashlib
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
from torch import nn

import make_orbax_fixture as fixture
from myriad_tpu import checkpoint as jax_ckpt
from myriad_tpu.common import optim as jax_optim
from myriad_tpu.runners.runner_base import RunnerBase as JaxRunner
from myriad_tpu.tasks.image_text_pretrain import ImageTextPretrainTask as JaxTask
from myriad_tpu_torch import checkpoint as ckpt_lib
from myriad_tpu_torch.convert_from_jax import state_dict_from_jax
from myriad_tpu_torch.models.layers import Dense, Policy
from myriad_tpu_torch.orbax_format import zstd
from myriad_tpu_torch.orbax_format.ocdbt import OcdbtReader
from myriad_tpu_torch.runners.runner_base import RunnerBase as PortRunner
from myriad_tpu_torch.tasks.image_text_pretrain import ImageTextPretrainTask as PortTask
import torch_threads  # noqa: F401  (one torch thread a test process)

LEVELS = (1, 3, 9, 19)
KINDS = ("normal", "zeros", "ramp", "text")
N = 1 << 18  # bytes of each array: 256 KiB, two compressed blocks


@pytest.fixture(scope="module", autouse=True)
def decoder():
    """The decoder, built once for the file (workers share the build)."""
    return zstd.library()


def _data(kind: str) -> np.ndarray:
    rng = np.random.default_rng(3)
    if kind == "normal":
        return rng.normal(0, 0.02, N // 4).astype(np.float32)
    if kind == "zeros":
        return np.zeros(N // 4, np.float32)
    if kind == "ramp":
        return (np.arange(N) % 256 - 128).astype(np.int8)
    words = np.array(b"a crack on the bottle's neck; no defect on the cable. ".split())
    return np.frombuffer(b" ".join(rng.choice(words, N // 2)), np.uint8)[:N].copy()


def _ts_chunk(a: np.ndarray, level: int) -> bytes:
    """The zstd chunk tensorstore's zarr driver writes for ``a``."""
    arr = ts.open({"driver": "zarr", "kvstore": "memory://",
                   "metadata": {"shape": list(a.shape), "chunks": list(a.shape),
                                "dtype": a.dtype.str,
                                "compressor": {"id": "zstd", "level": level}}},
                  create=True).result()
    arr[...] = a
    return arr.kvstore.read("0").result().value


@pytest.fixture(scope="module")
def frames():
    return {(level, kind): (_ts_chunk(_data(kind), level), _data(kind).tobytes())
            for level in LEVELS for kind in KINDS}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("level", LEVELS)
def test_decoder_matches_libzstd(frames, level, kind):
    frame, raw = frames[level, kind]
    assert zstd.decompress(frame, len(raw)).tobytes() == raw
    assert zstd.decompress(frame).tobytes() == raw  # the size bounded by the headers


def _modes(frame: bytes) -> set:
    """The frame, block, literals and sequence-table modes a zstd input uses
    (RFC 8878 headers, walked without decoding)."""
    out, off = set(), 0
    while off < len(frame):
        magic = int.from_bytes(frame[off:off + 4], "little")
        if magic & 0xFFFFFFF0 == 0x184D2A50:
            out.add("frame:skippable")
            off += 8 + int.from_bytes(frame[off + 4:off + 8], "little")
            continue
        fhd = frame[off + 4]
        single, fcs, did, checksum = fhd >> 5 & 1, fhd >> 6, fhd & 3, fhd >> 2 & 1
        out.add("frame:content_size" if single or fcs else "frame:unknown_size")
        out.update({"frame:checksum"} if checksum else set())
        off += 5 + (1 - single) + (0, 1, 2, 4)[did] + ((1 if single else 0), 2, 4, 8)[fcs]
        while True:
            bh = int.from_bytes(frame[off:off + 3], "little")
            off += 3
            btype, size = bh >> 1 & 3, bh >> 3
            out.add("block:" + ("raw", "rle", "compressed")[btype])
            if btype == 2:
                out |= _block_modes(frame[off:off + size])
            off += 1 if btype == 1 else size
            if bh & 1:
                break
        off += 4 * checksum
    return out


def _block_modes(b: bytes) -> set:
    ltype, sf = b[0] & 3, b[0] >> 2 & 3
    if ltype <= 1:
        hsize = {0: 1, 2: 1, 1: 2, 3: 3}[sf]
        regen = int.from_bytes(b[:hsize], "little") >> (3 if hsize == 1 else 4)
        out = {"literals:" + ("raw", "rle")[ltype]}
        off = hsize + (regen if ltype == 0 else 1)
    else:
        hsize = (3, 3, 4, 5)[sf]
        bits = (10, 10, 14, 18)[sf]
        csize = int.from_bytes(b[:hsize], "little") >> (4 + bits) & ((1 << bits) - 1)
        out = {f"literals:{('huffman', 'treeless')[ltype - 2]}_{1 if sf == 0 else 4}_stream"}
        off = hsize + csize
    nseq = b[off]
    off += 1 if nseq < 128 else (2 if nseq < 255 else 3)
    if nseq == 0:
        return out | {"sequences:none"}
    for name, shift in (("ll", 6), ("of", 4), ("ml", 2)):
        out.add(f"sequences:{('predefined', 'rle', 'fse', 'repeat')[b[off] >> shift & 3]}")
    return out


ALL_MODES = {"frame:skippable", "frame:content_size", "frame:unknown_size", "frame:checksum",
             "block:raw", "block:rle", "block:compressed", "literals:raw", "literals:rle",
             "literals:huffman_1_stream", "literals:huffman_4_stream",
             "literals:treeless_1_stream", "literals:treeless_4_stream", "sequences:none",
             "sequences:predefined", "sequences:rle", "sequences:fse", "sequences:repeat"}


def _libzstd_frames():
    """libzstd's own frames (through tensorstore's codec where it can write
    them: known sizes and checksums come from the ``zstandard`` binding of
    the same library)."""
    zstandard = pytest.importorskip("zstandard")
    text = _data("text").tobytes()
    small = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(text[:5000])
    skip = (0x184D2A53).to_bytes(4, "little") + (3).to_bytes(4, "little") + b"abc"
    return {"checksum": (small, text[:5000]),
            "frames_and_skippable": (small + skip + small, text[:5000] * 2),
            "rle_block": (zstandard.ZstdCompressor(level=1).compress(b"\x07" * 300000),
                          b"\x07" * 300000),
            "raw_block": (zstandard.ZstdCompressor(level=1).compress(os.urandom(1000)), None)}


def test_every_mode_libzstd_emitted_was_decoded(frames):
    """Every mode of every frame above and of libzstd's checksummed,
    concatenated, skippable, RLE-block and raw-block frames decoded
    bit-exact; the modes no frame covers are listed in CHANGES.md."""
    cases = list(frames.values())
    for frame, raw in _libzstd_frames().values():
        cases.append((frame, raw))
    seen = set()
    for frame, raw in cases:
        out = zstd.decompress(frame).tobytes()
        if raw is not None:
            assert out == raw
        seen |= _modes(frame)
    assert seen <= ALL_MODES
    assert {"block:compressed", "block:raw", "block:rle", "literals:huffman_4_stream",
            "sequences:fse", "sequences:predefined", "frame:checksum",
            "frame:skippable"} <= seen, sorted(seen)
    print("modes no frame covers:", sorted(ALL_MODES - seen))


def test_xxh64_vectors():
    """The spec's empty-input vector, and libzstd's content checksums (the
    low 32 bits of XXH64, seed 0) over lengths that cross every tail branch."""
    zstandard = pytest.importorskip("zstandard")
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    data = np.random.default_rng(1).integers(0, 256, 300, dtype=np.uint8).tobytes()
    for n in (0, 1, 3, 4, 7, 8, 15, 31, 32, 33, 63, 100, 300):
        frame = zstandard.ZstdCompressor(write_checksum=True).compress(data[:n])
        assert zstd.xxh64(data[:n]) & 0xFFFFFFFF == int.from_bytes(frame[-4:], "little"), n
        assert zstd.decompress(frame).tobytes() == data[:n]


def test_truncated_flipped_and_dictionary_frames_raise(frames):
    zstandard = pytest.importorskip("zstandard")
    raw = _data("normal").tobytes()[:20000]
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(raw)
    for cut in (len(frame) - 1, len(frame) // 2, 6, 0):
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(frame[:cut], len(raw))
    flipped = bytearray(frame)
    flipped[len(frame) // 2] ^= 0x10
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(bytes(flipped), len(raw))
    # the same frame naming dictionary 7: the header's 1-byte dictionary id
    fhd = frame[4]
    named = frame[:4] + bytes([fhd | 1]) + frame[5:6] * (1 - (fhd >> 5 & 1)) + b"\x07" \
        + frame[6 - (fhd >> 5 & 1):]
    with pytest.raises(NotImplementedError, match="dictionary 7"):
        zstd.decompress(named)
    with pytest.raises(zstd.ZstdError, match="magic"):
        zstd.decompress(b"\x00" * 16, 4)


# -- OCDBT and restore ---------------------------------------------------------
def _kv_same(path):
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": "file://" + os.path.abspath(path) + "/"}).result()
    keys = [k.decode() for k in kv.list().result()]
    with OcdbtReader(path) as r:
        assert r.keys() == sorted(keys)
        for k in keys:
            assert r.get(k) == kv.read(k).result().value, k
    return keys


def test_ocdbt_reader_matches_tensorstore(tmp_path):
    """The fixture's JAX-written ring (root and per-process databases), and
    a database of many versions, deletions, indirect values and nodes small
    enough to stack four levels."""
    ring = os.path.join(fixture.OUT, "ring", "checkpoint_1")
    assert "model.llama_proj.kernel/0.0" in _kv_same(ring)
    _kv_same(os.path.join(ring, "ocdbt.process_0"))
    base = "file://" + str(tmp_path / "db") + "/"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": base,
                          "config": {"max_inline_value_bytes": 100,
                                     "max_decoded_node_bytes": 500,
                                     "compression": {"id": "zstd", "level": 5}}}).result()
    rng = np.random.default_rng(0)
    for j in range(3):
        with ts.Transaction() as txn:
            for _ in range(200):
                kv.with_transaction(txn).write(
                    f"p{j}/key{rng.integers(1000):04d}/x",
                    rng.integers(0, 256, int(rng.integers(0, 400)), dtype=np.uint8).tobytes()
                ).result()
    for j in range(20):
        kv.write(f"v{j}", b"x" * j).result()
    kv.delete_range(ts.KvStore.KeyRange("p1/key0", "p1/key05")).result()
    assert len(_kv_same(str(tmp_path / "db"))) > 400


def _same_tree(ours, ref, path=""):
    """``ours`` (the port's restore) equals orbax's ``ref``: containers,
    None, numbers, and arrays bit for bit with their dtype and shape."""
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and sorted(ours) == sorted(ref), path
        for k in ref:
            _same_tree(ours[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert type(ours) is type(ref) and len(ours) == len(ref), path
        for i, (a, b) in enumerate(zip(ours, ref)):
            _same_tree(a, b, f"{path}/{i}")
    elif ref is None or isinstance(ref, (int, float)):
        assert ours == ref and type(ours) is type(ref), path
    else:
        ref = np.asarray(ref)
        assert torch.is_tensor(ours) and tuple(ours.shape) == ref.shape, path
        assert str(ours.dtype).replace("torch.", "") == str(ref.dtype), (path, ours.dtype)
        raw = ours.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        assert raw == ref.tobytes(), path


def _jax_state(accum, clip, mu, steps=2):
    params = jax.tree_util.tree_map(jnp.asarray, fixture.trainables(5))
    tx = jax_optim.make_optimizer(lambda s: 1e-3, max_grad_norm=clip, accum_grad_iters=accum,
                                  mu_dtype=mu)
    opt = tx.init(params)
    update = jax.jit(tx.update)  # one compile; eager optax compiles every op
    rng = np.random.default_rng(2)
    for _ in range(steps):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(0, 0.1, p.shape).astype(np.float32)), params)
        updates, opt = update(grads, opt, params)
        params = optax.apply_updates(params, updates)
    return {"model": jax.tree_util.tree_map(np.asarray, params),
            "optimizer": jax.tree_util.tree_map(np.asarray, opt),
            "epoch": np.asarray(3), "global_step": np.asarray(7)}


@pytest.mark.parametrize("accum,clip,mu,ocdbt", [(1, None, None, True),
                                                 (2, 1.0, "bfloat16", True),
                                                 (2, 1.0, None, False)])
def test_restore_matches_orbax(tmp_path, accum, clip, mu, ocdbt):
    """The JAX ``CheckpointManager``'s ring state (OCDBT, Orbax's default) or
    the same state in the plain layout: the port's ``load_params`` gives
    orbax's tree."""
    state = _jax_state(accum, clip, mu)
    if ocdbt:
        path = jax_ckpt.CheckpointManager(str(tmp_path)).save(0, state)
    else:
        path = str(tmp_path / "plain")
        ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=False)).save(path, state)
    _same_tree(ckpt_lib.load_params(path), ocp.StandardCheckpointer().restore(path))


def test_committed_fixture_matches_its_seed_and_expected(tmp_path):
    """The fixture's state regenerated from its seed and saved again by the
    JAX ``CheckpointManager`` restores (orbax) to the committed ring's tree;
    orbax's restore and the port's both match ``expected.json``, and the
    frames decode to their listed digests."""
    with open(os.path.join(fixture.OUT, "expected.json")) as f:
        expected = json.load(f)
    path = os.path.join(fixture.OUT, expected["checkpoint"])
    ref = ocp.StandardCheckpointer().restore(path)
    again = jax_ckpt.CheckpointManager(str(tmp_path)).save(1, fixture.state(expected["seed"]))
    regenerated = ocp.StandardCheckpointer().restore(again)
    assert fixture.describe(regenerated) == expected["leaves"] == fixture.describe(ref)
    ours = ckpt_lib.load_params(path)
    _same_tree(ours, ref)
    for name, spec in expected["frames"].items():
        with open(os.path.join(fixture.OUT, "frames", f"{name}.zst"), "rb") as f:
            out = zstd.decompress(f.read(), spec["size"]).tobytes()
        level, kind = fixture.FRAMES[name]
        assert out == fixture.frame_data(kind)
        assert hashlib.sha256(out).hexdigest() == spec["sha256"]


# -- the runner ------------------------------------------------------------------
RUN = dict(init_lr=1e-3, min_lr=0.0, warmup_lr=1e-5, warmup_steps=2, max_epoch=4,
           iters_per_epoch=5, weight_decay=0.05, lr_sched="linear_warmup_cosine_lr",
           prefetch=False, num_workers=0, shuffle_train=False, batch_size_train=2, seed=3)


def _cfg(tmp_path, name, **run):
    run_cfg = dict(RUN, output_dir=str(tmp_path / name), **run)
    return types.SimpleNamespace(run_cfg=run_cfg, to_dict=lambda: {"run": {"seed": 3}})


def _opt_by_name(opt_state):
    """The optax state's adam ``count`` and moments, the moments by name."""
    inner = opt_state.inner_opt_state if hasattr(opt_state, "inner_opt_state") else opt_state
    adam = inner[-1][0]
    return int(adam.count), state_dict_from_jax(jax.tree_util.tree_map(np.asarray, adam.mu)), \
        state_dict_from_jax(jax.tree_util.tree_map(np.asarray, adam.nu))


def _port_opt(opt):
    return opt.count, dict(zip(opt.names, opt.mu)), dict(zip(opt.names, opt.nu))


def _equal_named(ours, ref):
    assert set(ours) == set(ref)
    for n, t in ref.items():
        assert torch.equal(ours[n].detach().cpu(), t), n


class _TwoLeaves:
    """The issue's two-leaf trainable tree {a: {kernel (3, 4), bias (4,)}} as
    a port model (one Dense) and as a JAX model's ``trainable``."""

    def __init__(self):
        self.module = nn.ModuleDict({"a": Dense(3, 4, policy=Policy.fp32(), device="cpu")})
        self.device = torch.device("cpu")
        g = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for p in self.module.parameters():
                p.copy_(torch.randn(p.shape, generator=g))
                p.requires_grad_(True)
        self.trainable = {"a": {"kernel": self.module["a"].weight.detach().t().numpy().copy(),
                                "bias": self.module["a"].bias.detach().numpy().copy()}}

    def trainable_parameters(self):
        return list(self.module.named_parameters())

    def trainable_state_dict(self):
        return dict(self.module.named_parameters())


def test_d3_jax_resume_misplaces_multisteps_state(tmp_path):
    """Deviation D3.  ``accum_grad_iters: 2`` on {a: {kernel (3, 4), bias
    (4,)}}: orbax restores ``MultiStepsState`` as a dict with sorted keys,
    and the JAX ``_resume`` rebuilds the state by leaf order, so
    ``mini_step`` gets the (4,) bias, ``gradient_step`` the (3, 4) kernel and
    ``acc_grads.a.bias`` a 0-d array, without an error.  The port restores by
    name: its state equals the saved optax state."""
    model = _TwoLeaves()
    tx = jax_optim.make_optimizer(lambda s: 1e-3, accum_grad_iters=2)
    params = jax.tree_util.tree_map(jnp.asarray, model.trainable)
    opt = tx.init(params)
    update = jax.jit(tx.update)
    for scale in (0.1, 0.2, 0.3):  # one update, then one gradient accumulated
        grads = jax.tree_util.tree_map(lambda p: jnp.full_like(p, scale), params)
        updates, opt = update(grads, opt, params)
        params = optax.apply_updates(params, updates)
    state = {"model": jax.tree_util.tree_map(np.asarray, params),
             "optimizer": jax.tree_util.tree_map(np.asarray, opt),
             "epoch": np.asarray(0), "global_step": np.asarray(3)}
    path = jax_ckpt.CheckpointManager(str(tmp_path / "ring")).save(0, state)

    jax_model = types.SimpleNamespace(trainable=model.trainable)
    jr = JaxRunner(_cfg(tmp_path, "jax", accum_grad_iters=2, resume_ckpt_path=path),
                   JaxTask(), jax_model, {})
    assert np.shape(jr._opt_state.mini_step) == (4,)
    assert np.shape(jr._opt_state.gradient_step) == (3, 4)
    assert np.shape(jr._opt_state.acc_grads["a"]["bias"]) == ()

    pr = PortRunner(_cfg(tmp_path, "port", accum_grad_iters=2, resume_ckpt_path=path), None,
                    model, {})
    o = pr.optimizer
    assert (o.count, o.mini_step) == (int(opt.gradient_step), int(opt.mini_step)) == (1, 1)
    named = lambda tree: state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree))
    adam = opt.inner_opt_state[0][0]
    _equal_named(dict(zip(o.names, o.mu)), named(adam.mu))
    _equal_named(dict(zip(o.names, o.nu)), named(adam.nu))
    _equal_named(dict(zip(o.names, o.acc)), named(opt.acc_grads))
    _equal_named(model.trainable_state_dict(), named(params))
    with pytest.raises(ValueError, match="mini_step|acc_grads|inner_opt_state"):
        broken = ckpt_lib.load_params(path)["optimizer"]
        del broken["acc_grads"]
        o.load_optax_tree(broken, pr._from_tree)


class _Rows:
    """A dataset of four rows."""

    def __len__(self):
        return 4

    def __getitem__(self, i):
        return {"x": np.float32(i)}

    def collater(self, rows):
        return {"x": np.asarray([r["x"] for r in rows])}


def _stub_task(base, agg):
    """``base`` with a training epoch that only counts its steps, and an
    evaluation that counts its batches and then is ``base``'s (the pretrain
    task's: None) or, with ``agg``, yields the metrics ``agg[epoch]``."""

    class Task(base):
        evaluated = []  # the batches of each evaluation

        def train_epoch(self, epoch, runner, data_loader, iters_per_epoch, log_freq=50):
            runner.global_step += iters_per_epoch
            return {"loss": "0.500"}

        def evaluation(self, model, data_loader):
            Task.evaluated.append(len(list(data_loader)))
            return [1] if agg is not None else base.evaluation(self, model, data_loader)

        def after_evaluation(self, val_result, split_name, epoch, **kwargs):
            return {"agg_metrics": agg[epoch], "split": split_name}

    return Task()


def _run(runner_cls, task_base, model, tmp_path, name, agg, **run):
    task = _stub_task(task_base, agg)
    runner = runner_cls(_cfg(tmp_path, name, **run), task, model, {"rows": {
        "train": _Rows(), "val": _Rows(), "test": _Rows()}})
    runner.train()
    files = sorted(os.listdir(runner.output_dir))
    with open(os.path.join(runner.output_dir, "log.txt")) as f:
        log = f.read()
    return runner, task, files, log


@pytest.mark.parametrize("agg", [None, (0.5, 0.7, 0.6, 0.7)])
def test_valid_splits_log_and_save_as_jax(tmp_path, agg):
    """``valid_splits: [val, test]`` over 4 epochs: with the pretrain task's
    evaluation (None) nothing is evaluated and no best is saved; with
    metrics, the first split's best ``agg_metrics`` saves
    ``checkpoint_best`` (epochs 0 and 1) and both splits are logged.  The
    same files and log lines as the JAX runner's."""
    model = _TwoLeaves()
    run = dict(valid_splits=["val", "test"], max_checkpoints=2)
    jr, jt, jfiles, jlog = _run(JaxRunner, JaxTask, types.SimpleNamespace(
        trainable=model.trainable), tmp_path, "jax", agg, **run)
    pr, pt, pfiles, plog = _run(PortRunner, PortTask, model, tmp_path, "port", agg, **run)
    assert pfiles == jfiles
    assert plog == jlog
    assert pr.global_step == jr.global_step == 20
    want = ["checkpoint_2", "checkpoint_3", "log.txt"]
    assert pfiles == (want if agg is None else ["checkpoint_2", "checkpoint_3",
                                               "checkpoint_best", "log.txt"])
    assert type(pt).evaluated == type(jt).evaluated == [2] * 8
    if agg is not None:
        best = ckpt_lib.load_params(os.path.join(pr.output_dir, "checkpoint_best"))
        assert int(best["epoch"]) == 1


def test_evaluate_only_resumes_trains_nothing_and_stops(tmp_path):
    """``evaluate: True`` with a ``resume_ckpt_path`` directory: loaded, no
    step trained, nothing saved, one epoch evaluated, as the JAX runner."""
    model = _TwoLeaves()
    first = PortRunner(_cfg(tmp_path, "first"), None, model, {})
    first.global_step = 5
    path = first._save_checkpoint(0)
    run = dict(evaluate=True, valid_splits=["val"], resume_ckpt_path=path)
    jr, jt, jfiles, jlog = _run(JaxRunner, JaxTask, types.SimpleNamespace(
        trainable=model.trainable), tmp_path, "jax", None, **run)
    pr, pt, pfiles, plog = _run(PortRunner, PortTask, model, tmp_path, "port", None, **run)
    assert (pr.start_epoch, pr.global_step) == (jr.start_epoch, jr.global_step) == (1, 5)
    assert pfiles == jfiles == ["log.txt"]
    assert plog == jlog
    assert type(pt).evaluated == type(jt).evaluated == [2]
