"""Convert the reference's pretrained torch checkpoints into npz parameter
files that ``weights:`` and ``ckpt:`` serve (counterpart of the
repository's ``tools/convert_weights.py``; torch and numpy only).

    # one tower
    python -m myriad_tpu_torch.tools.convert_weights llama --src vicuna-7b/ --out llama.npz
    python -m myriad_tpu_torch.tools.convert_weights eva --src eva_vit_g.pth --out vit.npz
    python -m myriad_tpu_torch.tools.convert_weights simplenet --src heads/ --out heads_npz/

    # every tower found under a directory of the reference's files, with a
    # sha256 manifest and the `weights:` YAML stanza
    python -m myriad_tpu_torch.tools.convert_weights all --src ckpts/ --out npz/ \\
        [--llama vicuna-7b/] [--decoder pytorch_visa_model.pt] [--use_lora]

A source is a torch file (its ``model`` entry when it has one) or a
directory of ``pytorch_model*.bin``, ``*.pth`` and ``*.safetensors`` shards,
read with ``torch.load(weights_only=True)`` and the port's own safetensors
reader.  The trees are the JAX package's (``myriad_tpu_torch.convert``), in
float32; ``all`` writes ``<tower>.npz``, ``manifest.json`` and
``weights.yaml`` as the JAX tool does.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import re
from typing import Dict, Mapping

import numpy as np
import torch

from myriad_tpu_torch import checkpoint as ckpt_lib
from myriad_tpu_torch.convert import (convert_anomaly_decoder_state_dict,
                                      convert_eva_vit_state_dict,
                                      convert_imagebind_state_dict, convert_llama_state_dict,
                                      convert_myriad_trainables_state_dict,
                                      convert_qformer_state_dict,
                                      convert_simplenet_head_state_dict,
                                      convert_wide_resnet50_state_dict)
from myriad_tpu_torch.models.imagebind import ImageBindConfig
from myriad_tpu_torch.models.llama import LlamaConfig

TOWERS = ["llama", "eva", "qformer", "imagebind", "decoder", "llama_proj", "simplenet",
          "wideresnet", "all"]

#: the reference's checkpoint file names, per tower
ALL_TOWER_GLOBS = {
    "vit": ["eva_vit_g*.pth"],
    "qformer": ["blip2_pretrained*.pth", "blip2*.pth"],
    "llama_proj": ["pretrained_minigpt4*.pth", "prerained_minigpt4*.pth"],
    "imagebind": ["imagebind_huge*.pth", "imagebind*.pth"],
    "decoder": ["pytorch_mvtec_model*.pt", "pytorch_visa_model*.pt", "pytorch_*_model.pt"],
}


def load_torch(src: str) -> Dict:
    """A state dict from a torch file (its ``model`` entry when it has one)
    or from a directory's shards, merged in sorted path order."""
    if os.path.isdir(src):
        sd: Dict = {}
        for shard in sorted(glob.glob(os.path.join(src, "pytorch_model*.bin"))
                            + glob.glob(os.path.join(src, "*.pth"))
                            + glob.glob(os.path.join(src, "*.safetensors"))):
            if shard.endswith(".safetensors"):
                sd.update(ckpt_lib.load_safetensors(shard))
            else:
                sd.update(torch.load(shard, map_location="cpu", weights_only=True))
        if not sd:
            raise SystemExit(f"no checkpoint shards found under {src}")
        return sd
    ckpt = torch.load(src, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and isinstance(ckpt.get("model"), dict):
        return ckpt["model"]
    return ckpt


def _infer_depth(sd: Mapping, pattern: str) -> int:
    pat = re.compile(pattern)
    idx = [int(m.group(1)) for k in sd if (m := pat.search(str(k)))]
    if not idx:
        raise SystemExit(f"no keys matching {pattern!r} in checkpoint")
    return max(idx) + 1


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def count_params(tree: Mapping) -> int:
    """The number of elements over a tree's leaves."""
    return sum(count_params(v) if isinstance(v, Mapping) else int(np.prod(np.shape(v)))
               for v in tree.values())


def _qformer_prefix(sd: Mapping) -> str:
    # BLIP-2 checkpoints prefix the BERT weights with 'Qformer.'
    return "Qformer.bert." if any(str(k).startswith("Qformer.") for k in sd) else "bert."


def _as_numpy(x) -> np.ndarray:
    return np.asarray(x.float().numpy() if hasattr(x, "float") else x)


def _llama_proj_tree(sd: Mapping) -> Dict:
    """llama_proj from the MiniGPT-4 base checkpoint, as the JAX tool writes it."""
    tree = {"llama_proj": {"kernel": _as_numpy(sd["llama_proj.weight"]).T}}
    if "llama_proj.bias" in sd:
        tree["llama_proj"]["bias"] = _as_numpy(sd["llama_proj.bias"])
    return tree


def find_sources(args) -> Dict[str, str]:
    """Each tower's source for ``all``: its flag, else the first file under
    ``--src`` that matches the reference's names; the Vicuna directory (the
    first subdirectory holding ``pytorch_model*.bin`` or ``*.safetensors``);
    and the trainables, the highest numeric ``checkpoint_N.pth`` (a
    non-numeric name only when no numeric one exists)."""
    sources: Dict[str, str] = {}
    for tower, globs in ALL_TOWER_GLOBS.items():
        explicit = getattr(args, tower, None)
        if explicit:
            sources[tower] = explicit
            continue
        for g in globs:
            hits = sorted(glob.glob(os.path.join(args.src, g)))
            if hits:
                sources[tower] = hits[0]
                break
    if args.llama:
        sources["llama"] = args.llama
    else:
        for d in sorted(os.listdir(args.src) if os.path.isdir(args.src) else []):
            full = os.path.join(args.src, d)
            if os.path.isdir(full) and (glob.glob(os.path.join(full, "pytorch_model*.bin"))
                                        or glob.glob(os.path.join(full, "*.safetensors"))):
                sources["llama"] = full
                break

    def epoch(path: str):
        m = re.search(r"checkpoint_(\d+)\.pth$", path)
        return (1, int(m.group(1))) if m else (0, -1)

    trainables = sorted(glob.glob(os.path.join(args.src, "checkpoint_*.pth")), key=epoch)
    if trainables:
        sources["trainables"] = trainables[-1]
    return sources


def convert_tower(tower: str, sd: Mapping, use_lora: bool = False) -> Dict:
    """One tower of ``all``'s naming, its depth read from the state dict."""
    if tower == "llama":
        cfg = LlamaConfig(use_lora=use_lora,
                          num_layers=_infer_depth(sd, r"model\.layers\.(\d+)\."))
        return convert_llama_state_dict(sd, cfg)["params"]
    if tower == "vit":
        return convert_eva_vit_state_dict(sd, depth=_infer_depth(sd, r"blocks\.(\d+)\."))[
            "params"]
    if tower == "qformer":
        return convert_qformer_state_dict(
            sd, num_layers=_infer_depth(sd, r"encoder\.layer\.(\d+)\."),
            prefix=_qformer_prefix(sd))["params"]
    if tower == "imagebind":
        depth = _infer_depth(sd, r"modality_trunks\.vision\.blocks\.(\d+)\.")
        cfg = ImageBindConfig() if depth == 32 else ImageBindConfig.tiny()
        return convert_imagebind_state_dict(sd, cfg)["params"]
    if tower == "decoder":
        return convert_anomaly_decoder_state_dict(
            sd, num_taps=_infer_depth(sd, r"fc\.(\d+)\."))["params"]
    if tower == "llama_proj":
        return _llama_proj_tree(sd)
    if tower == "trainables":
        return convert_myriad_trainables_state_dict(sd)["params"]
    raise ValueError(f"unknown tower {tower!r}")


def convert_all(args) -> Dict:
    """Convert every tower found (``find_sources``) into ``<out>/<tower>.npz``,
    then write ``manifest.json`` (source, npz, the npz's sha256 and the
    parameter count a tower) and ``weights.yaml`` (the ``weights:`` stanza
    and, for the trainables, a ``ckpt:`` line).  Returns the manifest."""
    os.makedirs(args.out, exist_ok=True)
    sources = find_sources(args)
    manifest, stanza = {}, {}
    for tower, src in sources.items():
        tree = convert_tower(tower, load_torch(src), use_lora=args.use_lora)
        out_path = os.path.join(args.out, f"{tower}.npz")
        ckpt_lib.save_params(out_path, tree)
        n = count_params(tree)
        manifest[tower] = {"source": os.path.abspath(src), "npz": os.path.abspath(out_path),
                           "sha256": _sha256(out_path), "params": int(n),
                           "params_m": round(n / 1e6, 3)}
        if tower != "trainables":
            stanza[tower] = os.path.abspath(out_path)
        print(f"[{tower}] {src} -> {out_path} ({n / 1e6:.1f}M params)")
    missing = [t for t in ("vit", "qformer", "llama", "llama_proj", "imagebind", "decoder")
               if t not in sources]
    if missing:
        print(f"WARNING: no source found for towers: {missing} "
              f"(pass --<tower> <path> explicitly)")
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    yaml_lines = ["model:", "  weights:"]
    yaml_lines += [f"    {k}: {v}" for k, v in sorted(stanza.items())]
    if "trainables" in manifest:
        yaml_lines += ["  # trainable ckpt (load via model.ckpt):",
                       f"  ckpt: {manifest['trainables']['npz']}"]
    yaml_text = "\n".join(yaml_lines) + "\n"
    with open(os.path.join(args.out, "weights.yaml"), "w") as f:
        f.write(yaml_text)
    print(f"manifest: {os.path.join(args.out, 'manifest.json')}")
    print("paste into your model config:\n" + yaml_text)
    return manifest


def convert_simplenet_heads(src: str, out: str) -> int:
    """``{src}/{class}/ckpt.pth`` -> ``{out}/{class}.npz``; returns the count."""
    os.makedirs(out, exist_ok=True)
    n_cls = 0
    for cls in sorted(os.listdir(src)):
        ckpt_path = os.path.join(src, cls, "ckpt.pth")
        if not os.path.isfile(ckpt_path):
            continue
        ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        ckpt_lib.save_params(os.path.join(out, f"{cls}.npz"),
                             convert_simplenet_head_state_dict(ckpt)["params"])
        n_cls += 1
    return n_cls


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("tower", choices=TOWERS)
    parser.add_argument("--src", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--use_lora", action="store_true")
    parser.add_argument("--depth", type=int, default=39, help="eva depth")
    for tower in ("vit", "qformer", "llama", "llama_proj", "imagebind", "decoder"):
        parser.add_argument(f"--{tower}", default=None, help=f"explicit {tower} source for `all`")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.tower == "all":
        convert_all(args)
        return 0
    if args.tower == "simplenet":
        n_cls = convert_simplenet_heads(args.src, args.out)
        print(f"wrote {n_cls} per-class head npz files to {args.out}")
        return 0
    sd = load_torch(args.src)
    if args.tower == "llama":
        tree = convert_llama_state_dict(sd, LlamaConfig(use_lora=args.use_lora))["params"]
    elif args.tower == "eva":
        tree = convert_eva_vit_state_dict(sd, depth=args.depth)["params"]
    elif args.tower == "qformer":
        tree = convert_qformer_state_dict(sd, prefix=_qformer_prefix(sd))["params"]
    elif args.tower == "imagebind":
        tree = convert_imagebind_state_dict(sd, ImageBindConfig())["params"]
    elif args.tower == "decoder":
        tree = convert_anomaly_decoder_state_dict(sd)["params"]
    elif args.tower == "wideresnet":
        tree = convert_wide_resnet50_state_dict(sd)["params"]
    else:  # llama_proj
        tree = _llama_proj_tree(sd)
    ckpt_lib.save_params(args.out, tree)
    print(f"wrote {args.out} ({count_params(tree) / 1e6:.1f}M params)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
