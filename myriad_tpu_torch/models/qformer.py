"""BLIP-2 Q-Former in query-only mode (counterpart of
``myriad_tpu/models/qformer.py``).

Per layer: self-attention over the query tokens, cross-attention from the
queries to the image tokens on every ``cross_attention_freq``-th layer, and
the query-branch FFN; post-LN residuals with BERT's eps 1e-12.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from myriad_tpu_torch.models.layers import (Dense, LayerNorm, Policy, dot_attention, gelu_exact,
                                            merge_heads, split_heads)


class BertSelfAttention(nn.Module):
    def __init__(self, dim: int, kv_dim: int, num_heads: int, *, policy: Policy, device):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = policy.compute_dtype
        kw = dict(policy=policy, device=device)
        self.query = Dense(dim, dim, **kw)
        self.key = Dense(kv_dim, dim, **kw)
        self.value = Dense(kv_dim, dim, **kw)
        self.attn_out = Dense(dim, dim, **kw)
        self.attn_ln = LayerNorm(dim, 1e-12, **kw)

    def forward(self, hidden: torch.Tensor, kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        kv = hidden if kv is None else kv
        q = split_heads(self.query(hidden), self.num_heads)
        k = split_heads(self.key(kv), self.num_heads)
        v = split_heads(self.value(kv), self.num_heads)
        out = self.attn_out(merge_heads(dot_attention(q, k, v)))
        return self.attn_ln(out + hidden).to(self.dtype)


class BertQueryFfn(nn.Module):
    def __init__(self, dim: int, intermediate: int, *, policy: Policy, device):
        super().__init__()
        self.dtype = policy.compute_dtype
        self.intermediate_query = Dense(dim, intermediate, policy=policy, device=device)
        self.output_query = Dense(intermediate, dim, policy=policy, device=device)
        self.ffn_ln = LayerNorm(dim, 1e-12, policy=policy, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.output_query(gelu_exact(self.intermediate_query(x)))
        return self.ffn_ln(h + x).to(self.dtype)


class QFormerLayer(nn.Module):
    def __init__(self, dim: int, encoder_dim: int, num_heads: int, intermediate: int,
                 has_cross_attention: bool, *, policy: Policy, device):
        super().__init__()
        kw = dict(policy=policy, device=device)
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
                 cross_attention_freq: int = 2, policy: Policy, device):
        super().__init__()
        self.dtype = policy.compute_dtype
        self.embeddings_ln = LayerNorm(hidden_size, 1e-12, policy=policy, device=device)
        self.layer = nn.ModuleList(
            QFormerLayer(hidden_size, encoder_dim, num_heads, intermediate_size,
                         i % cross_attention_freq == 0, policy=policy, device=device)
            for i in range(num_layers))

    def forward(self, query_embeds: torch.Tensor, encoder_states: torch.Tensor) -> torch.Tensor:
        x = self.embeddings_ln(query_embeds).to(self.dtype)
        enc = encoder_states.to(self.dtype)
        for layer in self.layer:
            x = layer(x, enc)
        return x
