"""Vision expert: frozen ImageBind + AnomalyGPT decoder anomaly maps
(counterpart of ``myriad_tpu/models/vision_expert.py``), zero-shot only.

Per tapped layer, the decoded patch tokens are L2-normalised and scored
against a 2-state (normal/abnormal) text prompt ensemble; the (g, g, 2)
logit map is upsampled (bilinear, align_corners) to the map size and
softmaxed; maps average over the taps.  The prompt-ensemble text features
are encoded once per class set and cached.  One-shot maps score the query's
raw patch tokens by cosine against a bank of reference-normal patch tokens
per class (``build_reference_bank``): anomaly = 1 - the best match,
averaged over the taps.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from myriad_tpu_torch.models.imagebind import (ImageBindConfig, ImageBindText,
                                               ImageBindVision, LinearLayerDecoder)
from myriad_tpu_torch.models.layers import Policy

# Prompt-ensemble constants, copied from myriad_tpu/models/vision_expert.py
# (the port imports nothing of the JAX package); tests/test_torch_myriad.py
# holds the copies equal.
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

    def patch_tokens(self, images: torch.Tensor) -> List[torch.Tensor]:
        """The trunk's raw taps without cls: a list of (B, P, vision_dim)."""
        _, taps = self.visual(images)
        return [t[:, 1:, :] for t in taps]

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

    def one_shot(self, images: torch.Tensor,
                 ref_tokens: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """images (B, H, W, 3); ref_tokens per tap (B, R, vision_dim), the
        bank rows of each sample's class -> (maps (B, map, map, 1), masks
        (B, g, g, 1)) = 1 - the best cosine match.  A zero (padding) row
        scores cosine 0, so it takes part in the max as it does in the JAX
        package."""
        q_tokens = self.patch_tokens(images)
        grid = int(np.sqrt(q_tokens[0].shape[1]))
        sims = []
        for q, r in zip(q_tokens, ref_tokens):
            q, r = q.float(), r.float()
            qn = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-6)
            rn = r / torch.linalg.vector_norm(r, dim=-1, keepdim=True).clamp_min(1e-6)
            sims.append(torch.matmul(qn, rn.transpose(1, 2)).amax(dim=-1))  # (B, P)
        sim = torch.stack(sims).mean(dim=0).reshape(-1, grid, grid)
        up = upsample_align_corners(sim, (self.map_size, self.map_size))
        return (1.0 - up)[..., None], 1.0 - sim[..., None]


@dataclasses.dataclass
class ReferenceSpec:
    """Which normal images form the one-shot bank: MVTec's images
    ``4 * round_index`` onwards, the first ``effective_k`` of them."""

    round_index: int = 0
    k_shot: int = 0

    @property
    def effective_k(self) -> int:
        return self.k_shot if self.k_shot > 0 else 1

    def mvtec_names(self) -> List[str]:
        base = self.round_index * 4
        return [f"{base + i:03d}.png" for i in range(4)][:self.effective_k]


class VisionExpert:
    """Host wrapper: owns the module, the tokenizer, the text-feature cache and
    the one-shot reference bank."""

    def __init__(self, module: AnomalyExpertModule, tokenizer=None,
                 class_names: Optional[Sequence[str]] = None):
        self.module = module
        self.tokenizer = tokenizer
        self.class_names: List[str] = list(class_names or (MVTEC_CLASS_NAMES
                                                           + VISA_CLASS_NAMES))
        self.class_index: Dict[str, int] = {c: i for i, c in enumerate(self.class_names)}
        self._text_feats: Optional[torch.Tensor] = None
        self._ref_bank: Optional[List[torch.Tensor]] = None

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

    @torch.inference_mode()
    def build_reference_bank(self, images_per_class: Mapping[str, np.ndarray]) -> None:
        """The one-shot bank: per tap, (C, max K * P, vision_dim) in the order
        of ``class_names``, from ``images_per_class`` (class -> (K, H, W, 3)
        preprocessed reference-normal images).  A class without images gets
        P zero rows; shorter classes are zero-padded to the longest.  The bank
        is kept in fp32, the dtype ``one_shot`` computes in."""
        cfg = self.module.config
        per_tap: List[List[torch.Tensor]] = [[] for _ in cfg.out_layers]
        for cls in self.class_names:
            imgs = images_per_class.get(cls)
            if imgs is None:
                p = (cfg.img_size // cfg.patch_size) ** 2
                for lst in per_tap:
                    lst.append(torch.zeros((p, cfg.vision_embed_dim), device=self.device))
                continue
            x = torch.as_tensor(np.asarray(imgs), dtype=torch.float32, device=self.device)
            for lst, t in zip(per_tap, self.module.patch_tokens(x)):
                lst.append(t.reshape(-1, t.shape[-1]).float())  # (K * P, D)
        max_len = max(int(t.shape[0]) for lst in per_tap for t in lst)
        pad = torch.nn.functional.pad
        self._ref_bank = [torch.stack([pad(t, (0, 0, 0, max_len - t.shape[0])) for t in lst])
                          for lst in per_tap]

    def scene_ids(self, scenes: Sequence[str]) -> torch.Tensor:
        return torch.tensor([self.class_index[s] for s in scenes], dtype=torch.int64,
                            device=self.device)

    @torch.inference_mode()
    def __call__(self, images: torch.Tensor, scenes: Sequence[str], one_shot: bool = False):
        idx = self.scene_ids(scenes)
        if one_shot:
            if self._ref_bank is None:
                raise ValueError("one-shot maps need build_reference_bank first")
            return self.module.one_shot(images, [bank[idx] for bank in self._ref_bank])
        if self._text_feats is None:
            self.build_text_features()
        return self.module.zero_shot(images, self._text_feats[idx])
