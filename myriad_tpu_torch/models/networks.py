"""Adaptor networks (counterpart of ``myriad_tpu/models/networks.py``).

The ViT feature adaptor and the two anomaly-map encoders.  Maps are
(B, H, W, 1) channels-last at the public interface; the conv pyramid runs
NCHW inside and returns tokens in the JAX package's row-major order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from myriad_tpu_torch.models.layers import Conv2d, Dense, Policy, new_param


class LoraAdaptorV2(nn.Module):
    """Residual low-rank pair dims -> r -> dims."""

    def __init__(self, dims: int = 1408, input_dim: int = 4, *, policy: Policy, device):
        super().__init__()
        self.conv1 = Dense(dims, input_dim, use_bias=False, policy=policy, device=device)
        self.conv2 = Dense(input_dim, dims, use_bias=False, policy=policy, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(self.conv1(x))
        return h + x.to(h.dtype)


class _ConvPyramid(nn.Module):
    """5 x [conv3x3 -> ReLU -> maxpool 2]: (B, C, 224, 224) -> (B, 1024 C, 7, 7)."""

    def __init__(self, dim_in: int = 1, *, policy: Policy, device):
        super().__init__()
        widths = [dim_in * m for m in (4, 16, 64, 256, 1024)]
        ins = [dim_in] + widths[:-1]
        self.conv = nn.ModuleList(Conv2d(i, o, 3, padding=1, policy=policy, device=device)
                                  for i, o in zip(ins, widths))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.conv:
            x = F.max_pool2d(F.relu(conv(x)), 2, 2)
        return x


def _maps_nchw(maps: torch.Tensor, dtype) -> torch.Tensor:
    return maps.to(dtype).permute(0, 3, 1, 2)


class VEInstructorV2(nn.Module):
    """Anomaly map -> 49 expert tokens x out_dim for the Q-Former (version 0,
    the one Myriad uses; versions 1 and 2 are not ported)."""

    def __init__(self, dim_in: int = 1, out_dim: int = 768, *, policy: Policy, device):
        super().__init__()
        self.dtype = policy.compute_dtype
        self.out_dim = out_dim
        self.pyramid = _ConvPyramid(dim_in, policy=policy, device=device)
        self.head = Conv2d(dim_in * 1024, out_dim, 1, policy=policy, device=device)

    def forward(self, maps: torch.Tensor) -> torch.Tensor:
        """maps (B, 224, 224, dim_in) -> (B, 49, out_dim)."""
        x = self.head(self.pyramid(_maps_nchw(maps, self.dtype)))
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, self.out_dim)


class VETokenizer(nn.Module):
    """Anomaly map -> 9 learned base prompts + 9 map tokens = 18 LLM tokens."""

    def __init__(self, dim_in: int = 1, llm_dim: int = 4096, *, policy: Policy, device):
        super().__init__()
        self.dtype = policy.compute_dtype
        self.llm_dim = llm_dim
        self.pyramid = _ConvPyramid(dim_in, policy=policy, device=device)
        self.head = Conv2d(dim_in * 1024, llm_dim, 5, policy=policy, device=device)
        self.base_prompts = new_param((9, llm_dim), policy.param_dtype, device)

    def forward(self, maps: torch.Tensor) -> torch.Tensor:
        """maps (B, 224, 224, dim_in) -> (B, 18, llm_dim)."""
        x = self.head(self.pyramid(_maps_nchw(maps, self.dtype)))  # (B, llm, 3, 3)
        b = x.shape[0]
        img_prompts = x.permute(0, 2, 3, 1).reshape(b, 9, self.llm_dim)
        base = self.base_prompts.to(img_prompts.dtype).expand(b, 9, self.llm_dim)
        return torch.cat([base, img_prompts], dim=1)
