"""Hierarchical YAML config with the reference's three-level merge (counterpart
of ``myriad_tpu/common/config.py``).

A user YAML with ``model:``, ``datasets:`` and ``run:`` sections is merged over
(1) the default YAML of the model's ``model_type`` and (2) each dataset's
default YAML, and ``--options a.b=c`` overrides are applied last.  The YAML is
read by ``yaml_subset`` (the card has no PyYAML), and the defaults are the
port's own copies under ``myriad_tpu_torch/configs/``.  The archs and
datasets are the ones the port serves: ``MODELS`` and ``DATASET_CONFIGS``.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Callable, Dict, Iterable, List, Mapping, NamedTuple, Optional

from myriad_tpu_torch.common import yaml_subset

CONFIG_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "configs")


def _myriad():
    from myriad_tpu_torch.models.myriad import Myriad

    return Myriad


def _mini_gpt4():
    from myriad_tpu_torch.models.mini_gpt4 import MiniGPT4

    return MiniGPT4


class ModelEntry(NamedTuple):
    load: Callable[[], type]  # the model class, imported when asked for
    default_model_type: str
    configs: Dict[str, str]  # model_type -> default YAML under CONFIG_ROOT


MODELS = {"myriad": ModelEntry(_myriad, "pretrain_vicuna",
                               {"pretrain_vicuna": "models/minigpt4.yaml"}),
          "mini_gpt4": ModelEntry(_mini_gpt4, "pretrain_vicuna",
                                  {"pretrain_vicuna": "models/minigpt4.yaml"})}
# dataset name -> {type: default YAML under CONFIG_ROOT}
DATASET_CONFIGS = {
    "anomaly_detection": {"default": "datasets/anomaly_detection/base.yaml"},
    "two_class_anomaly_detection": {"default": "datasets/anomaly_detection/2cls.yaml"},
    "laion": {"default": "datasets/laion/defaults.yaml"},
    "cc_sbu": {"default": "datasets/cc_sbu/defaults.yaml"},
    "cc_sbu_align": {"default": "datasets/cc_sbu/align.yaml"},
    "panda": {"default": "datasets/panda/base.yaml"},
}


def _lookup(kind: str, table: Mapping, name: str):
    try:
        return table[name]
    except KeyError:
        raise KeyError(f"Unknown {kind} '{name}'. Registered: "
                       f"[{', '.join(sorted(table))}]") from None


def get_model_class(arch: str) -> type:
    return _lookup("model", MODELS, arch).load()


class ConfigDict(dict):
    """dict with attribute access, deep merge and dot-list overrides."""

    def __init__(self, data: Optional[Mapping] = None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, v: Any) -> Any:
        if isinstance(v, Mapping) and not isinstance(v, ConfigDict):
            return cls(v)
        if isinstance(v, list):
            return [cls._wrap(i) for i in v]
        return v

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = self._wrap(value)

    def __setitem__(self, name, value):
        super().__setitem__(name, self._wrap(value))

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __deepcopy__(self, memo):
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def merge(self, other: Optional[Mapping]) -> "ConfigDict":
        """Deep-merge ``other`` on top of self (other wins). Returns self."""
        if other is None:
            return self
        for k, v in other.items():
            if k in self and isinstance(self[k], ConfigDict) and isinstance(v, Mapping):
                self[k].merge(v)
            else:
                self[k] = self._wrap(v)
        return self

    def set_dotted(self, key: str, value: Any) -> None:
        parts = key.split(".")
        node = self
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], ConfigDict):
                node[p] = ConfigDict()
            node = node[p]
        node[parts[-1]] = value

    def to_dict(self) -> Dict:
        out: Dict = {}
        for k, v in self.items():
            if isinstance(v, ConfigDict):
                out[k] = v.to_dict()
            elif isinstance(v, list):
                out[k] = [i.to_dict() if isinstance(i, ConfigDict) else i for i in v]
            else:
                out[k] = v
        return out


def _parse_option_value(raw: str) -> Any:
    # numeric forms YAML 1.1 misses, e.g. "1e-4"
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    try:
        return yaml_subset.load(raw)
    except yaml_subset.YAMLSubsetError:
        return raw


def parse_dotlist(options: Optional[Iterable[str]]) -> ConfigDict:
    """Parse ``["a.b=c", ...]`` CLI overrides."""
    cfg = ConfigDict()
    if not options:
        return cfg
    for opt in options:
        if "=" not in opt:
            raise ValueError(f"Override '{opt}' is not in key=value form")
        key, raw = opt.split("=", 1)
        cfg.set_dotted(key.strip(), _parse_option_value(raw))
    return cfg


def load_yaml(path: str) -> ConfigDict:
    return ConfigDict(yaml_subset.load_file(path) or {})


class Config:
    """The merged run/model/datasets config."""

    def __init__(self, args=None, cfg_path: Optional[str] = None,
                 options: Optional[List[str]] = None):
        if args is not None:
            cfg_path = getattr(args, "cfg_path", cfg_path)
            options = getattr(args, "options", options)
        if cfg_path is None:
            raise ValueError("Config requires a cfg_path")

        user = load_yaml(cfg_path)
        overrides = parse_dotlist(options)

        self.config = ConfigDict()
        self.config.merge({"run": copy.deepcopy(user.get("run", ConfigDict()))})
        self.config.merge({"model": self._build_model_config(user, overrides)})
        self.config.merge({"datasets": self._build_dataset_config(user)})
        self.config.merge(overrides)

    @staticmethod
    def _build_model_config(user: ConfigDict, overrides: ConfigDict) -> ConfigDict:
        model = user.get("model")
        if model is None:
            return ConfigDict()
        arch = overrides.get("model", ConfigDict()).get("arch", model.get("arch"))
        if arch is None:
            raise KeyError("Missing model.arch in config")
        entry = _lookup("model", MODELS, arch)
        model_type = model.get("model_type", entry.default_model_type)
        base = ConfigDict()
        rel = entry.configs.get(model_type)
        if rel is not None:
            base = load_yaml(os.path.join(CONFIG_ROOT, rel)).get("model", ConfigDict())
        base.merge(model)
        return base

    @staticmethod
    def _build_dataset_config(user: ConfigDict) -> ConfigDict:
        datasets = user.get("datasets")
        if datasets is None:
            return ConfigDict()
        merged = ConfigDict()
        for name, ds_cfg in datasets.items():
            configs = _lookup("builder", DATASET_CONFIGS, name)
            rel = configs.get((ds_cfg or ConfigDict()).get("type", "default"))
            base = ConfigDict()
            if rel is not None:
                base = load_yaml(os.path.join(CONFIG_ROOT, rel)).get(
                    "datasets", ConfigDict()).get(name, ConfigDict())
            base.merge(ds_cfg)
            merged[name] = base
        return merged

    @property
    def run_cfg(self) -> ConfigDict:
        return self.config.run

    @property
    def model_cfg(self) -> ConfigDict:
        return self.config.model

    @property
    def datasets_cfg(self) -> ConfigDict:
        return self.config.datasets

    def to_dict(self) -> Dict:
        return self.config.to_dict()
