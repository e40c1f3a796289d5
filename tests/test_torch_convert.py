"""The port's converters of the reference's torch checkpoints
(``myriad_tpu_torch/convert/``), its ``convert_weights`` tool and its
safetensors reader against the JAX package's, on the CPU.

* Each converter against its JAX function on state dicts under the
  reference's names (``chip_smoke.reference_state_dicts`` at
  ``MyriadArch.tiny``, drawn from a numpy seed; SimpleNet's head and
  WideResNet-50 trunk written here), stored in fp32 and in fp16: the same
  key paths in the same order, and every leaf of the same dtype, shape and
  bytes (tolerance 0).  On bf16 the JAX converters raise ``TypeError``
  (numpy has no bfloat16); the port converts a bf16 state dict exactly as
  the JAX one converts its fp32 widening (deviation D2).
* ``load_torch`` over a ``.pth`` with a ``model`` entry, a directory of
  ``pytorch_model-0000x.bin`` shards (both against the JAX tool's
  ``load_torch``) and a directory of F32, F16 and BF16 ``*.safetensors``
  shards (against the ``safetensors`` package's ``load_file``); the reader
  over every dtype it takes, and ``chip_smoke.write_safetensors`` read back
  by ``load_file``.
* ``convert_weights all`` in process against the JAX tool's
  ``convert_all`` (imported by path) on one tree of the reference's files:
  the same npz arrays (tolerance 0), manifest towers, sources and counts,
  each npz's own sha256, and the same ``weights.yaml`` stanza.  Then a tiny
  port ``Myriad`` serves the port's npz through ``weights:`` and ``ckpt:``
  and a tiny JAX ``Myriad`` serves the JAX tool's: the same load reports and
  every parameter equal, leaf by leaf through ``jax_path_of``.
"""

import importlib.util
import json
import os
import types

import jax
import numpy as np
import pytest
import torch
from safetensors.torch import load_file, save_file

from myriad_tpu import convert as jax_convert
from myriad_tpu.models.imagebind import ImageBindConfig as JaxIbConfig
from myriad_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from myriad_tpu_torch import convert
from myriad_tpu_torch.checkpoint import load_safetensors
from myriad_tpu_torch.convert_from_jax import jax_leaves, jax_path_of, state_dict_from_jax
from myriad_tpu_torch.models.imagebind import ImageBindConfig
from myriad_tpu_torch.models.llama import LlamaConfig
from myriad_tpu_torch.models.myriad import Myriad, MyriadArch
from myriad_tpu_torch.tools import convert_weights
import chip_smoke
from test_torch_myriad import REPO, TracedInitMyriad
import torch_threads  # noqa: F401  (one torch thread a test process)


def _jax_tool():
    """The repository's ``tools/convert_weights.py`` (the JAX tool), by path."""
    spec = importlib.util.spec_from_file_location(
        "jax_convert_weights", os.path.join(REPO, "tools", "convert_weights.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _randn(seed):
    rng = np.random.default_rng(seed)
    return lambda shape: torch.from_numpy(np.asarray(rng.standard_normal(shape), np.float32))


def _simplenet_ckpt(randn):
    """A per-class SimpleNet ``ckpt.pth`` (pre-projection, a two-layer
    discriminator) at narrow widths."""
    return {"pre_projection": {"layers.0fc.weight": randn((6, 6)),
                               "layers.0fc.bias": randn((6,))},
            "discriminator": {"body.block1.0.weight": randn((4, 6)),
                              "body.block1.0.bias": randn((4,)),
                              "body.block1.1.weight": randn((4,)),
                              "body.block1.1.bias": randn((4,)),
                              "body.block1.1.running_mean": randn((4,)),
                              "body.block1.1.running_var": 1 + randn((4,)).abs(),
                              "tail.weight": randn((1, 4))}}


def _wide_resnet(randn):
    """torchvision ``wide_resnet50_2``'s names for layers 1-3 (the converter
    reads no shapes, so every conv is 2x2x3x3 and every norm of 2)."""
    sd = {"conv1.weight": randn((2, 2, 3, 3))}

    def bn(prefix):
        sd.update({prefix + ".weight": randn((2,)), prefix + ".bias": randn((2,)),
                   prefix + ".running_mean": randn((2,)),
                   prefix + ".running_var": 1 + randn((2,)).abs()})

    bn("bn1")
    for stage, blocks in (("layer1", 3), ("layer2", 4), ("layer3", 6)):
        for i in range(blocks):
            for j in (1, 2, 3):
                sd[f"{stage}.{i}.conv{j}.weight"] = randn((2, 2, 3, 3))
                bn(f"{stage}.{i}.bn{j}")
            if i == 0:
                sd[f"{stage}.{i}.downsample.0.weight"] = randn((2, 2, 1, 1))
                bn(f"{stage}.{i}.downsample.1")
    return sd


def _state_dicts(seed=0):
    """{converter case: state dict} under the reference's names."""
    randn = _randn(seed)
    arch = MyriadArch.tiny()
    sds = chip_smoke.reference_state_dicts(arch, randn)
    llama = dict(sds["llama"])
    lora = {}
    for i in range(arch.llama.num_layers):
        for proj in ("q_proj", "v_proj"):
            pre = f"model.layers.{i}.self_attn.{proj}."
            llama[pre + "lora_A.weight"] = randn((8, arch.llama.hidden_size))
            llama[pre + "lora_B.weight"] = randn((arch.llama.hidden_size, 8))
            lora[f"llama_model.base_model.model.{pre}lora_A.default.weight"] = llama[
                pre + "lora_A.weight"]
            lora[f"llama_model.base_model.model.{pre}lora_B.default.weight"] = llama[
                pre + "lora_B.weight"]
    trainables = dict(sds["trainables"], **sds["llama_proj"], **lora,
                      query_tokens=sds["qformer"]["query_tokens"])
    return {"llama": llama, "eva": sds["vit"], "qformer": sds["qformer"],
            "imagebind": sds["imagebind"], "decoder": sds["decoder"],
            "trainables": trainables, "simplenet_head": _simplenet_ckpt(randn),
            "wideresnet": _wide_resnet(randn)}


# case -> (the JAX converter's call, the port's)
CONVERTERS = {
    "llama": (lambda sd: jax_convert.convert_llama_state_dict(
                  sd, JaxLlamaConfig.tiny(use_lora=True)),
              lambda sd: convert.convert_llama_state_dict(sd, LlamaConfig.tiny(use_lora=True))),
    "eva": (lambda sd: jax_convert.convert_eva_vit_state_dict(sd, depth=2),
            lambda sd: convert.convert_eva_vit_state_dict(sd, depth=2)),
    "qformer": (lambda sd: jax_convert.convert_qformer_state_dict(sd, 2, prefix="Qformer.bert."),
                lambda sd: convert.convert_qformer_state_dict(sd, 2, prefix="Qformer.bert.")),
    "imagebind": (lambda sd: jax_convert.convert_imagebind_state_dict(sd, JaxIbConfig.tiny()),
                  lambda sd: convert.convert_imagebind_state_dict(sd, ImageBindConfig.tiny())),
    "decoder": (lambda sd: jax_convert.convert_anomaly_decoder_state_dict(sd, num_taps=2),
                lambda sd: convert.convert_anomaly_decoder_state_dict(sd, num_taps=2)),
    "trainables": (jax_convert.convert_myriad_trainables_state_dict,
                   convert.convert_myriad_trainables_state_dict),
    "simplenet_head": (jax_convert.convert_simplenet_head_state_dict,
                       convert.convert_simplenet_head_state_dict),
    "wideresnet": (jax_convert.convert_wide_resnet50_state_dict,
                   convert.convert_wide_resnet50_state_dict),
}


@pytest.fixture(scope="module")
def state_dicts():
    return _state_dicts()


def _cast(sd, dtype):
    return {k: _cast(v, dtype) if isinstance(v, dict) else v.to(dtype) for k, v in sd.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def _same_tree(ours, ref):
    ours, ref = _flat(ours), _flat(ref)
    assert list(ours) == list(ref)
    for key, want in ref.items():
        got = ours[key]
        assert (got.dtype, got.shape) == (want.dtype, want.shape), key
        assert got.tobytes() == want.tobytes(), key


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16], ids=["fp32", "fp16"])
@pytest.mark.parametrize("case", sorted(CONVERTERS))
def test_converter_matches_jax(state_dicts, case, dtype):
    jax_fn, port_fn = CONVERTERS[case]
    sd = _cast(state_dicts[case], dtype)
    _same_tree(port_fn(sd), jax_fn(sd))


@pytest.mark.parametrize("case", sorted(CONVERTERS))
def test_bf16_converts_as_its_fp32_widening(state_dicts, case):
    """D2: the JAX converters raise on bf16; the port widens it first."""
    jax_fn, port_fn = CONVERTERS[case]
    sd = _cast(state_dicts[case], torch.bfloat16)
    with pytest.raises(TypeError, match="BFloat16"):
        jax_fn(sd)
    _same_tree(port_fn(sd), jax_fn(_cast(sd, torch.float32)))


def _shards(root, sd, layout):
    """Write ``sd`` under ``root`` in one of the reference's layouts; returns
    the source and the oracle's state dict."""
    names = sorted(sd)
    parts = (names[::2], names[1::2])
    if layout == "pth_model_entry":
        torch.save({"model": sd, "epoch": 3}, root / "ckpt.pth")
        return str(root / "ckpt.pth"), None
    if layout == "bin_shards":
        for i, part in enumerate(parts):
            torch.save({k: sd[k] for k in part}, root / f"pytorch_model-0000{i + 1}-of-00002.bin")
        return str(root), None
    oracle = {}
    for i, (part, dtype) in enumerate(zip(parts + (names[:3],),
                                          (torch.float32, torch.float16, torch.bfloat16))):
        path = str(root / f"model-0000{i + 1}-of-00003.safetensors")
        save_file({k: sd[k].to(dtype) for k in part}, path, metadata={"format": "pt"})
        oracle.update(load_file(path))
    return str(root), oracle


@pytest.mark.parametrize("layout", ["pth_model_entry", "bin_shards", "safetensors_shards"])
def test_load_torch_reads_the_reference_layouts(state_dicts, tmp_path, layout):
    src, oracle = _shards(tmp_path, state_dicts["llama"], layout)
    ours = convert_weights.load_torch(src)
    if oracle is None:
        oracle = _jax_tool().load_torch(src)
    assert list(ours) == list(oracle)
    for k, v in oracle.items():
        assert ours[k].dtype == v.dtype and torch.equal(ours[k], v), k


def test_safetensors_reader_takes_every_dtype(tmp_path):
    rng = np.random.default_rng(5)
    tensors = {f"t_{dtype}".replace("torch.", ""): torch.from_numpy(
        rng.normal(size=(3, 5)).astype(np.float32) * 50).to(dtype)
        for dtype in (torch.float64, torch.float32, torch.float16, torch.bfloat16, torch.int64,
                      torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool)}
    tensors.update(scalar=torch.tensor(2.5), empty=torch.zeros(0, 4))
    save_file(tensors, str(tmp_path / "t.safetensors"), metadata={"note": "x"})
    ours = load_safetensors(str(tmp_path / "t.safetensors"))
    for k, v in load_file(str(tmp_path / "t.safetensors")).items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        assert torch.equal(ours[k], v), k
    head = json.dumps({"a": {"dtype": "F8_E4M3", "shape": [1], "data_offsets": [0, 1]}})
    (tmp_path / "bad.safetensors").write_bytes(len(head).to_bytes(8, "little")
                                               + head.encode() + b"\x00")
    with pytest.raises(ValueError, match="F8_E4M3"):
        load_safetensors(str(tmp_path / "bad.safetensors"))


def test_chip_smoke_writes_safetensors_the_package_reads(tmp_path):
    rng = np.random.default_rng(6)
    tensors = {n: torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float32)).to(d)
               for n, d in (("a", torch.float32), ("b", torch.float16), ("c", torch.bfloat16))}
    chip_smoke.write_safetensors(str(tmp_path / "w.safetensors"), tensors)
    back = load_file(str(tmp_path / "w.safetensors"))
    assert list(back) == list(tensors)
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


ALL_DTYPES = {"vit": torch.float16, "llama": torch.float16}


@pytest.fixture(scope="module")
def converted_both(tmp_path_factory):
    """One tree of the reference's files at ``MyriadArch.tiny`` (EVA-ViT and
    the Vicuna shards in fp16), converted by both tools' ``all``."""
    root = tmp_path_factory.mktemp("reference")
    sds = chip_smoke.reference_state_dicts(MyriadArch.tiny(), _randn(1))
    chip_smoke.write_reference_tree(str(root / "src"), sds, seed=1, dtypes=ALL_DTYPES)
    outs = {}
    for side in ("jax", "port"):
        args = types.SimpleNamespace(src=str(root / "src"), out=str(root / side),
                                     use_lora=False, vit=None, qformer=None, llama=None,
                                     llama_proj=None, imagebind=None, decoder=None)
        (_jax_tool().convert_all if side == "jax" else convert_weights.convert_all)(args)
        outs[side] = root / side
    return root, outs


def test_convert_all_writes_what_the_jax_tool_writes(converted_both):
    root, outs = converted_both
    manifests = {side: json.loads((out / "manifest.json").read_text())
                 for side, out in outs.items()}
    assert list(manifests["port"]) == list(manifests["jax"])
    assert set(manifests["port"]) == set(chip_smoke.REFERENCE_FILES)
    for tower, ref in manifests["jax"].items():
        ours = manifests["port"][tower]
        for key in ("source", "params", "params_m"):
            assert ours[key] == ref[key], (tower, key)
        assert ours["npz"] == str(outs["port"] / f"{tower}.npz")
        assert ours["sha256"] == convert_weights._sha256(ours["npz"])
        with np.load(ref["npz"]) as want, np.load(ours["npz"]) as got:
            assert sorted(got.files) == sorted(want.files), tower
            for k in want.files:
                assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
                assert got[k].tobytes() == want[k].tobytes(), (tower, k)
    stanzas = {side: (out / "weights.yaml").read_text().replace(str(out), "OUT")
               for side, out in outs.items()}
    assert stanzas["port"] == stanzas["jax"]
    assert "ckpt: OUT/trainables.npz" in stanzas["port"]


def test_the_converted_npz_serve_as_the_jax_ones(converted_both):
    """The port's npz through ``weights:`` and ``ckpt:`` into a tiny port
    Myriad, the JAX tool's into a tiny JAX Myriad: the same reports, every
    tower leaf covered, and every parameter equal through ``jax_path_of``."""
    import yaml

    _, outs = converted_both
    stanzas = {side: yaml.safe_load((out / "weights.yaml").read_text())["model"]
               for side, out in outs.items()}
    jm = TracedInitMyriad.from_config({"arch_preset": "tiny", "param_policy": "fp32",
                                       **stanzas["jax"]})
    pm = Myriad.from_config({"arch_preset": "tiny", "param_policy": "fp32", **stanzas["port"]},
                            device="cpu")
    pm.init_random(0)
    # the JAX from_config keeps no report: loading the towers again gives it
    ours, ref = pm.weights_report, jm.load_pretrained_weights(dict(stanzas["jax"]["weights"]))
    assert ours["missing"] == ref["missing"] == []
    for tower in ref["loaded"]:
        assert sorted(ours["loaded"][tower]) == sorted(ref["loaded"][tower]), tower
    for module, tree in ((pm.module, jm.params), (pm.vision_expert.module,
                                                  jm.vision_expert.params["params"])):
        ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree))
        paths = {path for path, _, _ in jax_leaves(jax.tree_util.tree_map(np.asarray, tree))}
        sd = module.state_dict()
        assert set(sd) == set(ref)
        for name, t in sd.items():
            assert jax_path_of(module, name) in paths, name
            np.testing.assert_array_equal(t.numpy(), ref[name].numpy(), err_msg=name)


# a tower's command -> (its source in the reference tree, extra flags); the
# single-tower commands take the full architectures' depths (32 LLaMA layers,
# 12 Q-Former layers, ImageBind-huge's 32 + 24 blocks, 4 decoder taps)
SINGLE = {"llama": ("vicuna-7b", []), "eva": ("eva_vit_g.pth", ["--depth", "2"]),
          "qformer": ("blip2_pretrained.pth", []), "imagebind": ("imagebind_huge.pth", []),
          "decoder": ("pytorch_mvtec_model.pt", []),
          "llama_proj": ("pretrained_minigpt4.pth", []), "wideresnet": ("wrn.pth", []),
          "simplenet": ("heads", [])}


@pytest.fixture(scope="module")
def single_tree(tmp_path_factory):
    """The reference's files at the single-tower commands' depths, narrow."""
    root = tmp_path_factory.mktemp("single")
    arch = MyriadArch.tiny(qformer_layers=12, llama=LlamaConfig.tiny(num_layers=32),
                           imagebind=ImageBindConfig.tiny(vision_num_blocks=32,
                                                          text_num_blocks=24,
                                                          out_layers=(1, 3, 5, 7)))
    randn = _randn(2)
    chip_smoke.write_reference_tree(str(root), chip_smoke.reference_state_dicts(arch, randn),
                                    seed=2)
    torch.save(_wide_resnet(randn), root / "wrn.pth")
    for cls in ("bottle", "cable"):
        (root / "heads" / cls).mkdir(parents=True)
        torch.save(_simplenet_ckpt(randn), root / "heads" / cls / "ckpt.pth")
    return root


@pytest.mark.parametrize("tower", sorted(SINGLE))
def test_single_tower_command_matches_jax(single_tree, tmp_path, monkeypatch, tower):
    """``python -m myriad_tpu_torch.tools.convert_weights <tower>`` writes the
    arrays the JAX tool's command writes (tolerance 0)."""
    import sys

    name, flags = SINGLE[tower]
    src = str(single_tree / name)
    outs = {side: tmp_path / side / ("" if tower == "simplenet" else f"{tower}.npz")
            for side in ("jax", "port")}
    monkeypatch.setattr(sys, "argv", ["convert_weights.py", tower, "--src", src,
                                      "--out", str(outs["jax"]), *flags])
    _jax_tool().main()
    assert convert_weights.main([tower, "--src", src, "--out", str(outs["port"]), *flags]) == 0
    files = {side: sorted(out.glob("*.npz")) if tower == "simplenet" else [out]
             for side, out in outs.items()}
    assert [f.name for f in files["port"]] == [f.name for f in files["jax"]]
    assert files["port"]
    for ours, ref in zip(files["port"], files["jax"]):
        with np.load(ref) as want, np.load(ours) as got:
            assert sorted(got.files) == sorted(want.files)
            for k in want.files:
                assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
