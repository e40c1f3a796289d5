"""ImageBind-huge vision and text towers (counterpart of
``myriad_tpu/models/imagebind.py``).

Vision: the video stem's Conv3d over two identical frames, already summed
over time into a 2-D patch conv; pre-LN trunk returning the raw block
outputs at ``out_layers``; head LN -> cls -> projection -> L2 norm.  Text:
causal trunk, EOS pooling at the argmax token id, projection, L2 norm times
the learned logit scale.  ``LinearLayerDecoder`` projects each tap's patch
tokens with its own Dense.  ``ImageBindConfig.weight_dtype`` "int8" quantizes
the trunks' projections (``in_proj``, ``out_proj``, ``fc1``, ``fc2``;
``IMAGEBIND_QUANT_PATTERN``); ``head_proj`` and the decoder stay float.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch
from torch import nn

from myriad_tpu_torch.models.layers import (Conv2d, Dense, LayerNorm, Policy, dot_attention,
                                            gelu_exact, merge_heads, new_param, split_heads,
                                            tower_dense)
from myriad_tpu_torch.ops.preprocess import u8_normalize


@dataclasses.dataclass(frozen=True)
class ImageBindConfig:
    vision_embed_dim: int = 1280
    vision_num_blocks: int = 32
    vision_num_heads: int = 16
    text_embed_dim: int = 1024
    text_num_blocks: int = 24
    text_num_heads: int = 16
    out_embed_dim: int = 1024
    img_size: int = 224
    patch_size: int = 14
    context_length: int = 77
    vocab_size: int = 49408
    out_layers: Tuple[int, ...] = (7, 15, 23, 31)
    weight_dtype: str = "bf16"  # "int8": the trunks' projections quantized

    @staticmethod
    def tiny(**overrides) -> "ImageBindConfig":
        base = ImageBindConfig(vision_embed_dim=64, vision_num_blocks=4, vision_num_heads=4,
                               text_embed_dim=48, text_num_blocks=2, text_num_heads=4,
                               out_embed_dim=32, img_size=28, patch_size=14,
                               context_length=16, vocab_size=64, out_layers=(1, 3))
        return dataclasses.replace(base, **overrides)


class TorchMha(nn.Module):
    """torch.nn.MultiheadAttention layout: packed in_proj + out_proj."""

    def __init__(self, dim: int, num_heads: int, *, weight_dtype: str = "bf16",
                 policy: Policy, device):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj = tower_dense(weight_dtype, dim, 3 * dim, policy=policy, device=device)
        self.out_proj = tower_dense(weight_dtype, dim, dim, policy=policy, device=device)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        q, k, v = self.in_proj(x).split(x.shape[-1], dim=-1)
        q, k, v = (split_heads(t, self.num_heads) for t in (q, k, v))
        return self.out_proj(merge_heads(dot_attention(q, k, v, mask=mask)))


class SimpleBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, *,
                 weight_dtype: str = "bf16", policy: Policy, device):
        super().__init__()
        self.dtype = policy.compute_dtype
        kw = dict(policy=policy, device=device)
        self.norm_1 = LayerNorm(dim, 1e-6, **kw)
        self.attn = TorchMha(dim, num_heads, weight_dtype=weight_dtype, **kw)
        self.norm_2 = LayerNorm(dim, 1e-6, **kw)
        hidden = int(dim * mlp_ratio)
        self.fc1 = tower_dense(weight_dtype, dim, hidden, **kw)
        self.fc2 = tower_dense(weight_dtype, hidden, dim, **kw)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        x = x + self.attn(self.norm_1(x).to(self.dtype), mask)
        return x + self.fc2(gelu_exact(self.fc1(self.norm_2(x).to(self.dtype))))


class SimpleTrunk(nn.Module):
    def __init__(self, dim: int, num_blocks: int, num_heads: int, *, pre_transformer_ln: bool,
                 out_layers: Sequence[int], policy: Policy, device, mlp_ratio: float = 4.0,
                 weight_dtype: str = "bf16"):
        super().__init__()
        self.dtype = policy.compute_dtype
        self.out_layers = tuple(out_layers)
        self.pre_ln = (LayerNorm(dim, 1e-6, policy=policy, device=device)
                       if pre_transformer_ln else None)
        self.blocks = nn.ModuleList(
            SimpleBlock(dim, num_heads, mlp_ratio, weight_dtype=weight_dtype, policy=policy,
                        device=device)
            for _ in range(num_blocks))

    def forward(self, x: torch.Tensor, mask=None) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        if self.pre_ln is not None:
            x = self.pre_ln(x).to(self.dtype)
        taps = []
        for i, blk in enumerate(self.blocks):
            x = blk(x, mask)
            if i in self.out_layers:
                taps.append(x)
        return x, taps


class ImageBindVision(nn.Module):
    """(B, H, W, 3) -> (cls embedding (B, out_dim) fp32, taps [(B, 1 + P, dim)])."""

    def __init__(self, cfg: ImageBindConfig, *, policy: Policy, device):
        super().__init__()
        self.cfg = cfg
        self.dtype = policy.compute_dtype
        dim = cfg.vision_embed_dim
        n_tok = (cfg.img_size // cfg.patch_size) ** 2 + 1
        self.rgbt_stem = Conv2d(3, dim, cfg.patch_size, stride=cfg.patch_size, use_bias=False,
                                policy=policy, device=device)
        self.cls_token = new_param((1, 1, dim), policy.param_dtype, device)
        self.pos_embed = new_param((1, n_tok, dim), policy.param_dtype, device)
        self.trunk = SimpleTrunk(dim, cfg.vision_num_blocks, cfg.vision_num_heads,
                                 pre_transformer_ln=True, out_layers=cfg.out_layers,
                                 weight_dtype=cfg.weight_dtype, policy=policy, device=device)
        self.head_ln = LayerNorm(dim, 1e-6, policy=policy, device=device)
        self.head_proj = Dense(dim, cfg.out_embed_dim, use_bias=False, policy=policy,
                               device=device, compute_dtype=torch.float32)

    def forward(self, images: torch.Tensor):
        if images.dtype == torch.uint8:
            images = u8_normalize(images, out_dtype=self.dtype)
        b = images.shape[0]
        dim = self.cfg.vision_embed_dim
        x = self.rgbt_stem(images.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, 1, dim), x], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        x, taps = self.trunk(x)
        h = self.head_proj(self.head_ln(x)[:, 0])
        return h / torch.linalg.vector_norm(h, dim=-1, keepdim=True), taps


class ImageBindText(nn.Module):
    """(B, L) token ids -> (B, out_dim) normalised embeddings times the logit scale."""

    def __init__(self, cfg: ImageBindConfig, *, policy: Policy, device):
        super().__init__()
        from myriad_tpu_torch.models.llama import Embed

        self.cfg = cfg
        self.token_embedding = Embed(cfg.vocab_size, cfg.text_embed_dim, policy=policy,
                                     device=device)
        self.pos_embed = new_param((1, cfg.context_length, cfg.text_embed_dim),
                                   policy.param_dtype, device)
        self.trunk = SimpleTrunk(cfg.text_embed_dim, cfg.text_num_blocks, cfg.text_num_heads,
                                 pre_transformer_ln=False, out_layers=(),
                                 weight_dtype=cfg.weight_dtype, policy=policy, device=device)
        self.head_ln = LayerNorm(cfg.text_embed_dim, 1e-6, policy=policy, device=device)
        self.head_proj = Dense(cfg.text_embed_dim, cfg.out_embed_dim, use_bias=False,
                               policy=policy, device=device, compute_dtype=torch.float32)
        self.log_logit_scale = new_param((), policy.param_dtype, device)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        b, n = token_ids.shape
        emb = self.token_embedding(token_ids)
        x = emb + self.pos_embed[:, :n].to(emb.dtype)
        causal = torch.tril(torch.ones((n, n), dtype=torch.bool, device=token_ids.device))
        mask = torch.where(causal, 0.0, -1e9)[None, None]
        x, _ = self.trunk(x, mask)
        h = self.head_ln(x)
        h = h[torch.arange(b, device=h.device), torch.argmax(token_ids, dim=-1)]
        h = self.head_proj(h)
        h = h / torch.linalg.vector_norm(h, dim=-1, keepdim=True)
        return h * torch.exp(self.log_logit_scale.float())


class LinearLayerDecoder(nn.Module):
    """Per-tap Dense vision_dim -> out_dim over the patch tokens (cls dropped)."""

    def __init__(self, in_dim: int, num_taps: int = 4, out_dim: int = 1024, *,
                 policy: Policy, device):
        super().__init__()
        self.fc = nn.ModuleList(Dense(in_dim, out_dim, policy=policy, device=device)
                                for _ in range(num_taps))

    def forward(self, taps: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if len(taps) != len(self.fc):
            raise ValueError(f"expected {len(self.fc)} taps, got {len(taps)}")
        return [fc(t[:, 1:, :]) for fc, t in zip(self.fc, taps)]
