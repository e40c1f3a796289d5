"""Attention dispatch for the LLM (counterpart of ``myriad_tpu/ops/attention.py``).

``mha`` routes by shape, with no switches: a single query row (a decode
step) goes to ``decode_attention`` (kernel B2 on the card), a chunk of rows
with absolute ``positions`` against a cache (prefill) to
``prefill_attention`` (kernel B3 on the card).  Each of those takes its
plain version for CPU tensors.  ``plain_mha`` is the twin of the JAX
package's ``_xla_mha`` and the plain version both kernels are held to.
"""

from __future__ import annotations

from typing import Optional

import torch


def causal_mask(positions: torch.Tensor, kv_len: int) -> torch.Tensor:
    """(B, Tq) absolute positions -> additive (B, 1, Tq, kv_len) fp32 mask: key
    slot t is seen by a query at position p when t <= p, else -1e9."""
    k_pos = torch.arange(kv_len, dtype=torch.int32, device=positions.device)
    allowed = k_pos[None, None, None, :] <= positions[:, None, :, None]
    return torch.where(allowed, 0.0, -1e9).to(torch.float32)


def plain_mha(q, k, v, mask=None, scale=None, k_scale=None, v_scale=None):
    """Twin of ``_xla_mha``: an int8 cache's per-position scales fold into the
    logits (k_scale) and the probabilities (v_scale); the probabilities are
    cast to q's dtype before p.V."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.to(q.dtype).float().transpose(-1, -2))
    if k_scale is not None:
        logits = logits * k_scale.transpose(-1, -2).float()
    logits = logits * scale
    if mask is not None:
        logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.transpose(-1, -2).float()
    return torch.matmul(probs.to(q.dtype), v.to(q.dtype))


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        mask: Optional[torch.Tensor] = None, scale: Optional[float] = None,
        k_scale: Optional[torch.Tensor] = None, v_scale: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
        kv_len: Optional[int] = None) -> torch.Tensor:
    """q (B, H, Tq, D); k/v (B, H, T, D); returns (B, H, Tq, D) in q's dtype.

    Decode (Tq == 1) attends over the first ``kv_len`` positions with the
    additive ``mask`` (B, 1, 1, kv_len); prefill attends causally by
    ``positions`` (B, Tq).  k_scale/v_scale (B, H, T, 1) carry an int8
    cache's per-position scales."""
    from myriad_tpu_torch.ops.decode_attention import decode_attention
    from myriad_tpu_torch.ops.prefill_attention import prefill_attention

    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.shape[2] == 1:
        return decode_attention(q, k, v, mask=mask, scale=scale, k_scale=k_scale,
                                v_scale=v_scale, kv_len=kv_len)
    if positions is None:
        raise ValueError("mha: a multi-row query needs absolute positions")
    return prefill_attention(q, k, v, positions, scale=scale, k_scale=k_scale,
                             v_scale=v_scale)
