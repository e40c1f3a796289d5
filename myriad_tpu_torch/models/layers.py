"""Shared building blocks with an explicit dtype policy (counterpart of
``myriad_tpu/models/layers.py``).

Parameters are stored in ``Policy.param_dtype``; products run in
``Policy.compute_dtype`` (bf16 on the card); LayerNorm and softmax compute
in fp32.  Modules allocate their parameters uninitialised on an explicit
device: a state dict (``convert_from_jax``) or ``init_random_`` fills them.
Dense weights are stored (out, in) as torch's; int8 weights stay (in, out)
with a per-column scale, the layout kernel B1 reads; int4 weights stay
packed (in/2, out) with (in/group, out) scales, the layout kernel B5 reads.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from myriad_tpu_torch.ops.quant import (int4_group, int4_matmul, int8_matmul,
                                        quantize_int4_grouped, quantize_per_channel)


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def fp32() -> "Policy":
        return Policy(torch.float32, torch.float32)

    @staticmethod
    def bf16() -> "Policy":
        """fp32 storage, bf16 compute: the JAX package's default policy."""
        return Policy(torch.float32, torch.bfloat16)

    @staticmethod
    def bf16_params() -> "Policy":
        """bf16 storage and compute: the serving profile on the card."""
        return Policy(torch.bfloat16, torch.bfloat16)


def new_param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised frozen parameter (serving: no gradients)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


class Dense(nn.Module):
    """Dense layer: y = x @ W^T (+ b) in the compute dtype."""

    def __init__(self, in_features: int, features: int, *, use_bias: bool = True,
                 policy: Policy, device, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = compute_dtype or policy.compute_dtype
        self.weight = new_param((features, in_features), policy.param_dtype, device)
        self.bias = new_param((features,), policy.param_dtype, device) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        return y if self.bias is None else y + self.bias.to(self.dtype)


class QuantDense(nn.Module):
    """Int8 weight-only Dense with no bias: w_int8 (in, out), scale (out,)."""

    def __init__(self, in_features: int, features: int, *, policy: Policy, device):
        super().__init__()
        self.dtype = policy.compute_dtype
        self.register_buffer("w_int8", torch.empty((in_features, features), dtype=torch.int8,
                                                   device=device))
        self.register_buffer("scale", torch.empty((features,), dtype=torch.float32,
                                                  device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_matmul(x.to(self.dtype), self.w_int8, self.scale, out_dtype=self.dtype)


class Quant4Dense(nn.Module):
    """Int4 group-wise weight-only Dense with no bias: w_int4 (in/2, out)
    uint8 and scale4 (in/group, out) fp32, named as the JAX package's."""

    def __init__(self, in_features: int, features: int, *, policy: Policy, device):
        super().__init__()
        self.dtype = policy.compute_dtype
        self.register_buffer("w_int4", torch.empty((in_features // 2, features),
                                                   dtype=torch.uint8, device=device))
        self.register_buffer("scale4", torch.empty((in_features // int4_group(in_features),
                                                    features), dtype=torch.float32,
                                                   device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int4_matmul(x.to(self.dtype), self.w_int4, self.scale4, out_dtype=self.dtype)


def maybe_quant_dense(weight_dtype: str, in_features: int, features: int, *,
                      policy: Policy, device) -> nn.Module:
    """A bias-free Dense, or its int8 or int4 serving twin, switched by
    ``weight_dtype``."""
    if weight_dtype == "int8":
        return QuantDense(in_features, features, policy=policy, device=device)
    if weight_dtype == "int4":
        return Quant4Dense(in_features, features, policy=policy, device=device)
    if weight_dtype != "bf16":
        raise NotImplementedError(f"weight_dtype {weight_dtype!r} is not ported")
    return Dense(in_features, features, use_bias=False, policy=policy, device=device)


class Conv2d(nn.Module):
    """2-D convolution over NCHW activations; weight stored (O, I, kh, kw)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, *, stride: int = 1,
                 padding: int = 0, use_bias: bool = True, policy: Policy, device):
        super().__init__()
        self.dtype = policy.compute_dtype
        self.stride, self.padding = stride, padding
        self.weight = new_param((out_ch, in_ch, kernel, kernel), policy.param_dtype, device)
        self.bias = new_param((out_ch,), policy.param_dtype, device) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), None, self.stride,
                     self.padding)
        return y if self.bias is None else y + self.bias.to(self.dtype)[:, None, None]


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics and output (params ``weight``/``bias``),
    in the JAX package's numerics: the fast variance E[x^2] - E[x]^2, clipped
    at 0."""

    def __init__(self, dim: int, eps: float, *, policy: Policy, device):
        super().__init__()
        self.eps = eps
        self.weight = new_param((dim,), policy.param_dtype, device)
        self.bias = new_param((dim,), policy.param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp_min((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return (xf - mean) * mul + self.bias.float()


class LayerNormFp32(nn.Module):
    """LayerNorm computed in fp32, cast back to the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, *, policy: Policy, device):
        super().__init__()
        self.ln = LayerNorm(dim, eps, policy=policy, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln(x).to(x.dtype)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)


class Mlp(nn.Module):
    """fc1 -> exact (erf) GELU -> fc2."""

    def __init__(self, dim: int, hidden: int, *, policy: Policy, device):
        super().__init__()
        self.fc1 = Dense(dim, hidden, policy=policy, device=device)
        self.fc2 = Dense(hidden, dim, policy=policy, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu_exact(self.fc1(x)))


def dot_attention(q, k, v, *, scale=None, mask=None):
    """Multi-head attention with an fp32 softmax: q (B,H,Tq,D), k/v (B,H,Tk,D);
    ``mask`` additive, broadcastable to (B,H,Tq,Tk)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(v.dtype), v)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


# ---------------------------------------------------------------------------
# seeded random initialisation (full-width runs on the card; no real weights)
# ---------------------------------------------------------------------------
@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator, std: float = 0.02) -> None:
    """Fill every parameter and buffer from ``generator`` (on the module's
    device): norms get ones/zeros, other floats N(0, std), int8 weights the
    per-column quantisation of N(0, std) draws as in ``quantize_per_channel``,
    int4 weights the group-wise one of ``quantize_int4_grouped``."""
    for mod in module.modules():
        if isinstance(mod, LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            continue
        if isinstance(mod, QuantDense):
            w = torch.empty(mod.w_int8.shape, dtype=torch.float32, device=mod.w_int8.device)
            w.normal_(0.0, std, generator=generator)
            w8, scale = quantize_per_channel(w)
            mod.w_int8.copy_(w8)
            mod.scale.copy_(scale)
            del w
        if isinstance(mod, Quant4Dense):
            shape = (mod.w_int4.shape[0] * 2, mod.w_int4.shape[1])
            w = torch.empty(shape, dtype=torch.float32, device=mod.w_int4.device)
            w.normal_(0.0, std, generator=generator)
            w4, scale4 = quantize_int4_grouped(w)
            mod.w_int4.copy_(w4)
            mod.scale4.copy_(scale4)
            del w
        for name, p in mod.named_parameters(recurse=False):
            if name in ("bias", "q_bias", "v_bias"):
                p.zero_()
            elif name == "log_logit_scale":
                p.fill_(math.log(1 / 0.07))
            elif getattr(mod, "is_norm", False):
                p.fill_(1.0)
            else:
                p.normal_(0.0, std, generator=generator)
