"""Shared building blocks with an explicit dtype policy (counterpart of
``myriad_tpu/models/layers.py``).

Parameters are stored in ``Policy.param_dtype``; products run in
``Policy.compute_dtype`` (bf16 on the card); LayerNorm and softmax compute
in fp32.  Modules allocate their parameters uninitialised on an explicit
device: a state dict (``convert_from_jax``) or ``init_random_`` fills them.
Dense weights are stored (out, in) as torch's; int8 weights stay (in, out)
with a per-column scale (and an optional bias), the layout kernel B1 reads;
int4 weights stay packed (in/2, out) with (in/group, out) scales, the layout
kernel B5 reads.

A projection built with a ``mesh`` (``parallel.mesh.Mesh``) is a
row-parallel shard: it holds this rank's input features, and its output is
summed over the model group in fp32 and rounded once (``ops.quant``'s row
rule; a float Dense sums fp32 products).  Under autograd the sum is
``Mesh.reduce_from_model``, whose backward passes the whole gradient on: a
row shard's dx is its own input rows' and needs no collective.  A
column-parallel shard needs no mesh: it is a narrower projection.
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
    """Dense layer: y = x @ W^T (+ b) in the compute dtype.  With ``mesh``, a
    row-parallel shard: the fp32 product of this rank's input features,
    summed over the model group, then rounded to the compute dtype."""

    def __init__(self, in_features: int, features: int, *, use_bias: bool = True,
                 policy: Policy, device, compute_dtype: Optional[torch.dtype] = None,
                 mesh=None):
        super().__init__()
        self.dtype = compute_dtype or policy.compute_dtype
        self.mesh = mesh
        self.weight = new_param((features, in_features), policy.param_dtype, device)
        self.bias = new_param((features,), policy.param_dtype, device) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mesh is not None:
            y = self.mesh.reduce_from_model(F.linear(x.to(self.dtype).float(),
                                                     self.weight.to(self.dtype).float()))
            y = y.to(self.dtype)
        else:
            y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        return y if self.bias is None else y + self.bias.to(self.dtype)


class QuantDense(nn.Module):
    """Int8 weight-only Dense: w_int8 (in, out), scale (out,) and, with
    ``use_bias``, a bias added after the product in the output dtype.  With
    ``mesh``, a row-parallel shard (``in_features`` this rank's, ``scale``
    whole)."""

    def __init__(self, in_features: int, features: int, *, use_bias: bool = False,
                 policy: Policy, device, mesh=None):
        super().__init__()
        self.dtype = policy.compute_dtype
        self.mesh = mesh
        self.register_buffer("w_int8", torch.empty((in_features, features), dtype=torch.int8,
                                                   device=device))
        self.register_buffer("scale", torch.empty((features,), dtype=torch.float32,
                                                  device=device))
        self.bias = new_param((features,), policy.param_dtype, device) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = int8_matmul(x.to(self.dtype), self.w_int8, self.scale, out_dtype=self.dtype,
                        mesh=self.mesh)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class Quant4Dense(nn.Module):
    """Int4 group-wise weight-only Dense with no bias: w_int4 (in/2, out)
    uint8 and scale4 (in/group, out) fp32, named as the JAX package's.  With
    ``mesh``, a row-parallel shard: ``in_features`` (this rank's, even: a
    nibble pair never straddles a shard) may start or end inside a group of
    the whole weight's (``ops.quant.int4_row_groups``), and ``scale4``
    stays the whole weight's (the rules replicate it)."""

    def __init__(self, in_features: int, features: int, *, policy: Policy, device, mesh=None):
        super().__init__()
        self.dtype = policy.compute_dtype
        self.mesh = mesh
        whole = in_features * (mesh.n_model if mesh is not None else 1)
        if in_features % 2:
            raise ValueError(f"int4 packing needs an even input dim, got {in_features}"
                             + (f" of the weight's {whole}" if mesh is not None else ""))
        group = int4_group(whole)
        self.register_buffer("w_int4", torch.empty((in_features // 2, features),
                                                   dtype=torch.uint8, device=device))
        self.register_buffer("scale4", torch.empty((whole // group, features),
                                                   dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int4_matmul(x.to(self.dtype), self.w_int4, self.scale4, out_dtype=self.dtype,
                           mesh=self.mesh)


def maybe_quant_dense(weight_dtype: str, in_features: int, features: int, *,
                      use_bias: bool = False, policy: Policy, device, mesh=None) -> nn.Module:
    """A Dense, or its int8 or int4 serving twin, switched by ``weight_dtype``
    (the int4 twin, the LLaMA's, has no bias); ``mesh``: a row-parallel
    shard."""
    if weight_dtype == "int8":
        return QuantDense(in_features, features, use_bias=use_bias, policy=policy,
                          device=device, mesh=mesh)
    if weight_dtype == "int4":
        return Quant4Dense(in_features, features, policy=policy, device=device, mesh=mesh)
    if weight_dtype != "bf16":
        raise NotImplementedError(f"weight_dtype {weight_dtype!r} is not ported")
    return Dense(in_features, features, use_bias=use_bias, policy=policy, device=device,
                 mesh=mesh)


def tower_dense(weight_dtype: str, in_features: int, features: int, *, use_bias: bool = True,
                policy: Policy, device) -> nn.Module:
    """A frozen tower's projection: the int8 ``QuantDense`` when
    ``weight_dtype`` is "int8", the float Dense for any other value (the
    JAX package's ``maybe_quant_dense``: a tower has no int4 twin)."""
    return maybe_quant_dense("int8" if weight_dtype == "int8" else "bf16", in_features,
                             features, use_bias=use_bias, policy=policy, device=device)


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
    """fc1 -> exact (erf) GELU -> fc2; ``weight_dtype`` "int8" quantizes both."""

    def __init__(self, dim: int, hidden: int, *, weight_dtype: str = "bf16", policy: Policy,
                 device):
        super().__init__()
        kw = dict(policy=policy, device=device)
        self.fc1 = tower_dense(weight_dtype, dim, hidden, **kw)
        self.fc2 = tower_dense(weight_dtype, hidden, dim, **kw)

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
