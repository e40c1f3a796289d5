"""Vision expert: frozen ImageBind + AnomalyGPT decoder anomaly maps
(counterpart of ``myriad_tpu/models/vision_expert.py``), zero-shot only.

Per tapped layer, the decoded patch tokens are L2-normalised and scored
against a 2-state (normal/abnormal) text prompt ensemble; the (g, g, 2)
logit map is upsampled (bilinear, align_corners) to the map size and
softmaxed; maps average over the taps.  The prompt-ensemble text features
are encoded once per class set and cached.  One-shot maps and the
reference bank are not ported yet.
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from myriad_tpu_torch.models.imagebind import (ImageBindConfig, ImageBindText,
                                               ImageBindVision, LinearLayerDecoder)
from myriad_tpu_torch.models.layers import Policy

# Prompt-ensemble constants, copied from myriad_tpu/models/vision_expert.py
# (importing that package pulls in JAX); tests/test_torch_myriad.py holds the
# copies equal.
PROMPT_NORMAL = [
    "{}", "flawless {}", "perfect {}", "unblemished {}",
    "{} without flaw", "{} without defect", "{} without damage",
]
PROMPT_ABNORMAL = [
    "damaged {}", "broken {}", "{} with flaw", "{} with defect", "{} with damage",
]
PROMPT_TEMPLATES = ["a photo of a {}.", "a photo of the {}."]

MVTEC_CLASS_NAMES = [
    "bottle", "cable", "capsule", "carpet", "grid", "hazelnut", "leather",
    "metal_nut", "pill", "screw", "tile", "toothbrush", "transistor", "wood",
    "zipper",
]
VISA_CLASS_NAMES = [
    "candle", "capsules", "cashew", "chewinggum", "fryum", "macaroni1",
    "macaroni2", "pcb1", "pcb2", "pcb3", "pcb4", "pipe_fryum",
]


def prompt_sentences_for(obj: str) -> Tuple[List[str], List[str]]:
    obj = obj.replace("_", " ")
    normal = [t.format(s.format(obj)) for s in PROMPT_NORMAL for t in PROMPT_TEMPLATES]
    abnormal = [t.format(s.format(obj)) for s in PROMPT_ABNORMAL for t in PROMPT_TEMPLATES]
    return normal, abnormal


def hash_tokenizer(vocab_size: int):
    """The JAX package's ``HashTokenizer``, loaded from its file by path: the
    file is stdlib-only, but importing it as ``myriad_tpu.models.*`` would run
    that package's ``__init__``, which imports JAX."""
    path = (Path(__file__).resolve().parents[2] / "myriad_tpu" / "models"
            / "clip_tokenizer.py")
    spec = importlib.util.spec_from_file_location("_myriad_clip_tokenizer", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.HashTokenizer(vocab_size)


@functools.lru_cache(maxsize=8)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """W (n_out, n_in) with W @ x == 1-D bilinear align_corners=True resize."""
    if n_in == 1:
        return np.ones((n_out, 1), np.float32)
    pos = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = (pos - lo).astype(np.float32)
    w = np.zeros((n_out, n_in), np.float32)
    w[np.arange(n_out), lo] += 1.0 - frac
    w[np.arange(n_out), hi] += frac
    return w


def upsample_align_corners(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """x (..., H, W) -> (..., H', W') bilinear align_corners=True, as two products."""
    h_in, w_in = x.shape[-2:]
    wh = torch.from_numpy(_resize_matrix(h_in, out_hw[0])).to(x.device)
    ww = torch.from_numpy(_resize_matrix(w_in, out_hw[1])).to(x.device)
    y = torch.matmul(wh, x.float())             # (..., H', W)
    return torch.matmul(y, ww.transpose(0, 1))  # (..., H', W')


class AnomalyExpertModule(nn.Module):
    """Frozen ImageBind vision + text towers and the LinearLayer decoder."""

    def __init__(self, config: ImageBindConfig, map_size: int = 224, *, policy: Policy,
                 device):
        super().__init__()
        self.config = config
        self.map_size = map_size
        self.visual = ImageBindVision(config, policy=policy, device=device)
        self.text = ImageBindText(config, policy=policy, device=device)
        self.image_decoder = LinearLayerDecoder(config.vision_embed_dim,
                                                num_taps=len(config.out_layers),
                                                out_dim=config.out_embed_dim, policy=policy,
                                                device=device)

    def encode_text(self, token_ids: torch.Tensor) -> torch.Tensor:
        return self.text(token_ids)

    def decoded_patch_tokens(self, images: torch.Tensor) -> List[torch.Tensor]:
        _, taps = self.visual(images)
        return self.image_decoder(taps)

    def zero_shot(self, images: torch.Tensor,
                  text_feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """images (B, H, W, 3); text_feats (B, 2, out_dim) L2-normalised ->
        (maps (B, map, map, 1), masks (B, g, g, 1)) in [0, 1]."""
        tokens = self.decoded_patch_tokens(images)
        grid = int(np.sqrt(tokens[0].shape[1]))
        maps, masks = [], []
        for tok in tokens:
            tok = tok.float()
            tok = tok / torch.linalg.vector_norm(tok, dim=-1, keepdim=True)
            sim = 100.0 * torch.matmul(tok, text_feats.float().transpose(1, 2))
            logit_map = sim.reshape(-1, grid, grid, 2)
            masks.append(torch.softmax(logit_map, dim=-1)[..., 1:])
            up = upsample_align_corners(logit_map.permute(0, 3, 1, 2),
                                        (self.map_size, self.map_size))
            maps.append(torch.softmax(up, dim=1)[:, 1][..., None])
        return torch.stack(maps).mean(dim=0), torch.stack(masks).mean(dim=0)


class VisionExpert:
    """Host wrapper: owns the module, the tokenizer and the text-feature cache."""

    def __init__(self, module: AnomalyExpertModule, tokenizer=None,
                 class_names: Optional[Sequence[str]] = None):
        self.module = module
        self.tokenizer = tokenizer
        self.class_names: List[str] = list(class_names or (MVTEC_CLASS_NAMES
                                                           + VISA_CLASS_NAMES))
        self.class_index: Dict[str, int] = {c: i for i, c in enumerate(self.class_names)}
        self._text_feats: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.module.visual.pos_embed.device

    @torch.inference_mode()
    def build_text_features(self) -> torch.Tensor:
        """Encode the prompt ensemble of every class once: (C, 2, out_dim)."""
        if self.tokenizer is None:
            raise ValueError("text features need a CLIP tokenizer")
        feats = []
        for cls in self.class_names:
            normal, abnormal = prompt_sentences_for(cls)
            ids = torch.tensor([self.tokenizer.encode(s, self.module.config.context_length)
                                for s in normal + abnormal], dtype=torch.int64,
                               device=self.device)
            emb = self.module.encode_text(ids)
            n = emb[:len(normal)].mean(dim=0)
            a = emb[len(normal):].mean(dim=0)
            feats.append(torch.stack([n / torch.linalg.vector_norm(n),
                                      a / torch.linalg.vector_norm(a)]))
        self._text_feats = torch.stack(feats)
        return self._text_feats

    def scene_ids(self, scenes: Sequence[str]) -> torch.Tensor:
        return torch.tensor([self.class_index[s] for s in scenes], dtype=torch.int64,
                            device=self.device)

    @torch.inference_mode()
    def __call__(self, images: torch.Tensor, scenes: Sequence[str]):
        if self._text_feats is None:
            self.build_text_features()
        return self.module.zero_shot(images, self._text_feats[self.scene_ids(scenes)])
