"""EVA-ViT-g/14 vision encoder (counterpart of ``myriad_tpu/models/eva_vit.py``).

Patch 14, embed 1408, depth 39, 16 heads, MLP 6144; fused qkv with the EVA
quirk of q and v biases and no k bias; absolute position embeddings;
pre-LN blocks (eps 1e-6) and no final norm (the caller's ln_vision).
``weight_dtype`` "int8" quantizes the block projections (``qkv``, ``proj``,
``fc1``, ``fc2``; ``EVA_QUANT_PATTERN``); the patch conv stays float.
Images are (B, H, W, 3) channels-last at the public interface.
``use_checkpoint`` recomputes each block in the backward
(``torch.utils.checkpoint``), as the JAX package's ``nn.remat`` does.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn

from myriad_tpu_torch.models.layers import (Conv2d, LayerNorm, Mlp, Policy, dot_attention,
                                            merge_heads, new_param, split_heads, tower_dense)


class EvaAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, *, weight_dtype: str = "bf16",
                 policy: Policy, device):
        super().__init__()
        self.num_heads = num_heads
        kw = dict(policy=policy, device=device)
        self.qkv = tower_dense(weight_dtype, dim, 3 * dim, use_bias=False, **kw)
        self.q_bias = new_param((dim,), policy.param_dtype, device)
        self.v_bias = new_param((dim,), policy.param_dtype, device)
        self.proj = tower_dense(weight_dtype, dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dim = x.shape[-1]
        q, k, v = self.qkv(x).split(dim, dim=-1)
        q = q + self.q_bias.to(q.dtype)
        v = v + self.v_bias.to(v.dtype)
        q, k, v = (split_heads(t, self.num_heads) for t in (q, k, v))
        out = dot_attention(q, k, v, scale=(dim // self.num_heads) ** -0.5)
        return self.proj(merge_heads(out))


class EvaBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_hidden: int, *,
                 weight_dtype: str = "bf16", policy: Policy, device):
        super().__init__()
        self.dtype = policy.compute_dtype
        kw = dict(weight_dtype=weight_dtype, policy=policy, device=device)
        self.norm1 = LayerNorm(dim, 1e-6, policy=policy, device=device)
        self.attn = EvaAttention(dim, num_heads, **kw)
        self.norm2 = LayerNorm(dim, 1e-6, policy=policy, device=device)
        self.mlp = Mlp(dim, mlp_hidden, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x).to(self.dtype))
        return x + self.mlp(self.norm2(x).to(self.dtype))


class EvaViT(nn.Module):
    """Returns all token states (B, 1 + P, embed_dim) with no final norm."""

    def __init__(self, *, img_size: int = 224, patch_size: int = 14, embed_dim: int = 1408,
                 depth: int = 39, num_heads: int = 16, mlp_ratio: float = 4.3637,
                 use_checkpoint: bool = False, weight_dtype: str = "bf16", policy: Policy,
                 device):
        super().__init__()
        self.embed_dim = embed_dim
        self.use_checkpoint = use_checkpoint
        num_patches = (img_size // patch_size) ** 2
        self.patch_embed = Conv2d(3, embed_dim, patch_size, stride=patch_size,
                                  policy=policy, device=device)
        self.cls_token = new_param((1, 1, embed_dim), policy.param_dtype, device)
        self.pos_embed = new_param((1, num_patches + 1, embed_dim), policy.param_dtype, device)
        mlp_hidden = int(embed_dim * mlp_ratio)
        self.blocks = nn.ModuleList(
            EvaBlock(embed_dim, num_heads, mlp_hidden, weight_dtype=weight_dtype,
                     policy=policy, device=device)
            for _ in range(depth))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) normalised float -> (B, 1 + P, embed_dim)."""
        b = images.shape[0]
        x = self.patch_embed(images.permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)  # row-major (h, w) token order
        cls = self.cls_token.to(x.dtype).expand(b, 1, self.embed_dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        for blk in self.blocks:
            if self.use_checkpoint and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(blk, x, use_reentrant=False)
            else:
                x = blk(x)
        return x
