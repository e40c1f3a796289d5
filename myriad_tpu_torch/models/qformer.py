"""BLIP-2 Q-Former in query-only mode (counterpart of
``myriad_tpu/models/qformer.py``).

Per layer: self-attention over the query tokens, cross-attention from the
queries to the image tokens on every ``cross_attention_freq``-th layer, and
the query-branch FFN; post-LN residuals with BERT's eps 1e-12.
``weight_dtype`` "int8" quantizes every projection (``query``, ``key``,
``value``, ``attn_out``, ``intermediate_query``, ``output_query``;
``QFORMER_QUANT_PATTERN``) in self- and cross-attention.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from myriad_tpu_torch.models.layers import (LayerNorm, Policy, dot_attention, gelu_exact,
                                            merge_heads, split_heads, tower_dense)


class BertSelfAttention(nn.Module):
    def __init__(self, dim: int, kv_dim: int, num_heads: int, *, weight_dtype: str = "bf16",
                 policy: Policy, device):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = policy.compute_dtype
        kw = dict(policy=policy, device=device)
        self.query = tower_dense(weight_dtype, dim, dim, **kw)
        self.key = tower_dense(weight_dtype, kv_dim, dim, **kw)
        self.value = tower_dense(weight_dtype, kv_dim, dim, **kw)
        self.attn_out = tower_dense(weight_dtype, dim, dim, **kw)
        self.attn_ln = LayerNorm(dim, 1e-12, **kw)

    def forward(self, hidden: torch.Tensor, kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        kv = hidden if kv is None else kv
        q = split_heads(self.query(hidden), self.num_heads)
        k = split_heads(self.key(kv), self.num_heads)
        v = split_heads(self.value(kv), self.num_heads)
        out = self.attn_out(merge_heads(dot_attention(q, k, v)))
        return self.attn_ln(out + hidden).to(self.dtype)


class BertQueryFfn(nn.Module):
    def __init__(self, dim: int, intermediate: int, *, weight_dtype: str = "bf16",
                 policy: Policy, device):
        super().__init__()
        self.dtype = policy.compute_dtype
        kw = dict(policy=policy, device=device)
        self.intermediate_query = tower_dense(weight_dtype, dim, intermediate, **kw)
        self.output_query = tower_dense(weight_dtype, intermediate, dim, **kw)
        self.ffn_ln = LayerNorm(dim, 1e-12, policy=policy, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.output_query(gelu_exact(self.intermediate_query(x)))
        return self.ffn_ln(h + x).to(self.dtype)


class QFormerLayer(nn.Module):
    def __init__(self, dim: int, encoder_dim: int, num_heads: int, intermediate: int,
                 has_cross_attention: bool, *, weight_dtype: str = "bf16", policy: Policy,
                 device):
        super().__init__()
        kw = dict(weight_dtype=weight_dtype, policy=policy, device=device)
        self.attention = BertSelfAttention(dim, dim, num_heads, **kw)
        self.crossattention = (BertSelfAttention(dim, encoder_dim, num_heads, **kw)
                               if has_cross_attention else None)
        self.ffn = BertQueryFfn(dim, intermediate, **kw)

    def forward(self, hidden, encoder_states):
        hidden = self.attention(hidden)
        if self.crossattention is not None:
            hidden = self.crossattention(hidden, kv=encoder_states)
        return self.ffn(hidden)


class QFormer(nn.Module):
    """(B, Q, hidden) queries x (B, T, encoder_dim) image tokens -> (B, Q, hidden)."""

    def __init__(self, *, hidden_size: int = 768, encoder_dim: int = 1408,
                 num_layers: int = 12, num_heads: int = 12, intermediate_size: int = 3072,
                 cross_attention_freq: int = 2, weight_dtype: str = "bf16", policy: Policy,
                 device):
        super().__init__()
        self.dtype = policy.compute_dtype
        self.embeddings_ln = LayerNorm(hidden_size, 1e-12, policy=policy, device=device)
        self.layer = nn.ModuleList(
            QFormerLayer(hidden_size, encoder_dim, num_heads, intermediate_size,
                         i % cross_attention_freq == 0, weight_dtype=weight_dtype,
                         policy=policy, device=device)
            for i in range(num_layers))

    def forward(self, query_embeds: torch.Tensor, encoder_states: torch.Tensor) -> torch.Tensor:
        x = self.embeddings_ln(query_embeds).to(self.dtype)
        enc = encoder_states.to(self.dtype)
        for layer in self.layer:
            x = layer(x, enc)
        return x
