"""SimpleNet vision expert (counterpart of ``myriad_tpu/models/simplenet.py``):
a PatchCore-style feature-adaptation anomaly detector.

WideResNet-50-2 features (layer2 and layer3) -> 3x3 neighbourhood patchify
-> per-patch mean pool to a common width -> layer aggregation to
``target_embed_dimension`` -> a per-class head (Projection + Discriminator);
anomaly score = -discriminator(feature).  The image score is the best patch
score; the map is the patch grid resized to ``map_size`` and smoothed by a
Gaussian (sigma 4) on the host, as the JAX package does.  BatchNorm runs in
inference mode with its running statistics as parameters.  Convolutions,
BatchNorm and the heads are plain ``torch.nn.functional`` ops in fp32, TF32
off on the card (``exact_fp32``): the JAX package computes them in XLA, not
in a Pallas kernel.  The trunk takes
and gives NHWC, as the JAX one; inside it runs NCHW.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import logging
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from myriad_tpu_torch.models.layers import new_param

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
INIT_SEED = 0  # the random trunk and heads that the npz leaves are merged over


@contextlib.contextmanager
def exact_fp32():
    """Convolutions and matmuls in fp32 proper on the card: TF32 off for cuDNN
    and cuBLAS while the block runs (PyTorch lets cuDNN convolutions take TF32
    by default), the flags restored after it."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class BatchNormInference(nn.Module):
    """Affine BN with stored running statistics (eval mode) over the channel
    axis ``axis``: ``weight`` (the JAX ``scale``), ``bias``, ``mean``, ``var``."""

    def __init__(self, channels: int, *, device, axis: int = 1, eps: float = 1e-5):
        super().__init__()
        self.axis, self.eps = axis, eps
        self.weight = new_param((channels,), torch.float32, device)
        self.bias = new_param((channels,), torch.float32, device)
        self.mean = new_param((channels,), torch.float32, device)
        self.var = new_param((channels,), torch.float32, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = [1] * x.dim()
        shape[self.axis] = -1
        inv = torch.rsqrt(self.var + self.eps)
        out = ((x.float() - self.mean.view(shape)) * inv.view(shape) * self.weight.view(shape)
               + self.bias.view(shape))
        return out.to(x.dtype)


class Conv(nn.Module):
    """A k x k convolution without bias, padding k // 2 (flax ``nn.Conv`` with
    explicit symmetric padding), NCHW."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1, *, device):
        super().__init__()
        self.stride, self.pad = stride, k // 2
        self.weight = new_param((out_ch, in_ch, k, k), torch.float32, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, stride=self.stride, padding=self.pad)


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, width: int, out_ch: int, stride: int = 1, *, device):
        super().__init__()
        self.conv1 = Conv(in_ch, width, 1, device=device)
        self.bn1 = BatchNormInference(width, device=device)
        self.conv2 = Conv(width, width, 3, stride, device=device)
        self.bn2 = BatchNormInference(width, device=device)
        self.conv3 = Conv(width, out_ch, 1, device=device)
        self.bn3 = BatchNormInference(out_ch, device=device)
        self.downsample_conv = self.downsample_bn = None
        if in_ch != out_ch or stride != 1:
            self.downsample_conv = Conv(in_ch, out_ch, 1, stride, device=device)
            self.downsample_bn = BatchNormInference(out_ch, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(h + identity)


class WideResNet50(nn.Module):
    """WideResNet-50-2 trunk returning the layer2 and layer3 feature maps."""

    STAGES = (("layer1", 3, 1, 256, 1), ("layer2", 4, 2, 512, 2), ("layer3", 6, 4, 1024, 2))

    def __init__(self, *, device, width_factor: int = 2):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, 2, device=device)
        self.bn1 = BatchNormInference(64, device=device)
        w, in_ch = 64 * width_factor, 64
        for name, blocks, mult, out_ch, stride in self.STAGES:
            for i in range(blocks):
                self.add_module(f"{name}_{i}", Bottleneck(in_ch, w * mult, out_ch,
                                                          stride if i == 0 else 1,
                                                          device=device))
                in_ch = out_ch

    def _stage(self, x: torch.Tensor, name: str, blocks: int) -> torch.Tensor:
        for i in range(blocks):
            x = getattr(self, f"{name}_{i}")(x)
        return x

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """images (B, H, W, 3) -> (layer2 (B, H/8, W/8, 512), layer3 (B, H/16, W/16, 1024))."""
        x = images.float().permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        x = self._stage(x, "layer1", 3)
        l2 = self._stage(x, "layer2", 4)
        l3 = self._stage(l2, "layer3", 6)
        return l2.permute(0, 2, 3, 1), l3.permute(0, 2, 3, 1)


def patchify_3x3(feat: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, C, 9): the 3x3 neighbourhood of each position
    (stride 1, zero padding)."""
    _, h, w, _ = feat.shape
    padded = F.pad(feat, (0, 0, 1, 1, 1, 1))
    return torch.stack([padded[:, dy:dy + h, dx:dx + w, :] for dy in range(3)
                        for dx in range(3)], dim=-1)


def adaptive_avg_pool_1d(x: torch.Tensor, out: int) -> torch.Tensor:
    """torch's ``adaptive_avg_pool1d`` over the last axis: the mean of each
    of ``out`` segments (the JAX package takes them as differences of one
    cumulative sum, which rounds long sums into the segments' means)."""
    lead = x.shape[:-1]
    return F.adaptive_avg_pool1d(x.reshape(-1, 1, x.shape[-1]), out).reshape(*lead, out)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` enlarging the last two axes of
    (N, C, H, W) (layer3 to layer2's grid, the patch grid to the map):
    half-pixel centres, and past the edge the edge pixel's value."""
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False)


class SimpleNetEmbedder(nn.Module):
    """Backbone + patch aggregation: (B, H, W, 3) -> ((B, H/8 * W/8, target_dim), (H/8, W/8))."""

    def __init__(self, *, device, pretrain_embed_dimension: int = 1536,
                 target_embed_dimension: int = 1536):
        super().__init__()
        self.pretrain_embed_dimension = pretrain_embed_dimension
        self.target_embed_dimension = target_embed_dimension
        self.backbone = WideResNet50(device=device)

    @exact_fp32()
    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
        l2, l3 = self.backbone(images)
        b, h2, w2 = l2.shape[:3]
        feats = []
        for f in (l2, l3):
            p = patchify_3x3(f)  # (B, h, w, C, 9)
            _, h, w, c, k = p.shape
            if (h, w) != (h2, w2):
                flat = p.reshape(b, h, w, c * k).permute(0, 3, 1, 2)
                p = resize_bilinear(flat, (h2, w2)).permute(0, 2, 3, 1)
            feats.append(adaptive_avg_pool_1d(p.reshape(b, h2 * w2, c * k),
                                              self.pretrain_embed_dimension))
        stacked = torch.stack(feats, dim=2)  # (B, P, L, D)
        agg = adaptive_avg_pool_1d(stacked.reshape(b, h2 * w2, -1), self.target_embed_dimension)
        return agg, (h2, w2)


class Linear(nn.Module):
    """flax ``nn.Dense`` in fp32: weight (out, in), optional bias."""

    def __init__(self, in_f: int, out_f: int, *, device, use_bias: bool = True):
        super().__init__()
        self.weight = new_param((out_f, in_f), torch.float32, device)
        self.bias = new_param((out_f,), torch.float32, device) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.float(), self.weight, self.bias)


class Projection(nn.Module):
    """``n_layers`` Linear layers, LeakyReLU(0.2) between them when
    ``layer_type`` > 1."""

    def __init__(self, in_planes: int, out_planes: int, n_layers: int = 1, layer_type: int = 0,
                 *, device):
        super().__init__()
        self.layer_type = layer_type
        self.fc = nn.ModuleList(Linear(in_planes if i == 0 else out_planes, out_planes,
                                       device=device) for i in range(n_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, fc in enumerate(self.fc):
            x = fc(x)
            if i < len(self.fc) - 1 and self.layer_type > 1:
                x = F.leaky_relu(x, 0.2)
        return x


class Discriminator(nn.Module):
    """(n_layers - 1) x [Linear + BN + LeakyReLU(0.2)], then Linear to 1
    without bias."""

    def __init__(self, in_planes: int, n_layers: int = 2, hidden: Optional[int] = 1024, *,
                 device):
        super().__init__()
        width = in_planes
        for i in range(n_layers - 1):
            out = hidden if hidden is not None else int(in_planes // 1.5)
            self.add_module(f"block{i + 1}_fc", Linear(width, out, device=device))
            self.add_module(f"block{i + 1}_bn", BatchNormInference(out, device=device, axis=-1))
            width = out
        self.n_layers = n_layers
        self.tail = Linear(width, 1, device=device, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, self.n_layers):
            x = getattr(self, f"block{i}_bn")(getattr(self, f"block{i}_fc")(x))
            x = F.leaky_relu(x, 0.2)
        return self.tail(x)


class SimpleHead(nn.Module):
    """Projection + Discriminator, one a class."""

    def __init__(self, *, device, target_embed_dimension: int = 1536, pre_proj: int = 1,
                 proj_layer_type: int = 0, dsc_layers: int = 2, dsc_hidden: int = 1024):
        super().__init__()
        d = target_embed_dimension
        self.pre_projection = (Projection(d, d, pre_proj, proj_layer_type, device=device)
                               if pre_proj > 0 else None)
        self.discriminator = Discriminator(d, dsc_layers, dsc_hidden, device=device)

    @exact_fp32()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pre_projection is not None:
            x = self.pre_projection(x)
        return self.discriminator(x)


@dataclasses.dataclass
class SimpleNetInterface:
    """Per-class inference: (images, class names) -> (image score + 1 (B,),
    anomaly map + 1 (B, map, map, 1)), numpy on the host, as the JAX one
    returns them.  ``heads`` maps a class to its head."""

    embedder: SimpleNetEmbedder
    heads: Dict[str, SimpleHead]
    map_size: int = 224
    smoothing_sigma: float = 4.0

    @property
    def device(self) -> torch.device:
        return self.embedder.backbone.conv1.weight.device

    @torch.inference_mode()
    def patch_scores(self, images: torch.Tensor, cls_names: Sequence[str]) -> torch.Tensor:
        """(B, h, w) patch scores: minus the class head's discriminator."""
        feats, (h, w) = self.embedder(images)
        scores = []
        for i, cls in enumerate(cls_names):
            scores.append(-self.heads[cls](feats[i])[..., 0])
        return torch.stack(scores).reshape(len(cls_names), h, w)

    def __call__(self, images: torch.Tensor, cls_names: Sequence[str]):
        from scipy import ndimage

        patch = self.patch_scores(images, list(cls_names))
        image_scores = patch.reshape(patch.shape[0], -1).amax(dim=-1)
        maps = resize_bilinear(patch[:, None], (self.map_size, self.map_size))[:, 0]
        maps = np.stack([ndimage.gaussian_filter(m, self.smoothing_sigma)
                         for m in maps.cpu().numpy()])
        # the reference returns scores + 1 and maps + 1
        return image_scores.cpu().numpy() + 1.0, maps[..., None] + 1.0


def init_simplenet_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded weights for a SimpleNet module: BN scale 1, bias and mean 0,
    var 1 (an identity); convolutions He-normal over their fan-in; Linear
    weights N(0, 1/fan_in), biases 0."""
    for mod in module.modules():
        if isinstance(mod, BatchNormInference):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.mean.zero_()
            mod.var.fill_(1.0)
        elif isinstance(mod, (Conv, Linear)):
            fan_in = int(np.prod(mod.weight.shape[1:]))
            gain = 2.0 if isinstance(mod, Conv) else 1.0
            mod.weight.normal_(0.0, float(np.sqrt(gain / fan_in)), generator=generator)
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()


def load_simplenet_interface(ckpt_root: str, backbone_path: Optional[str] = None,
                             map_size: int = 224, target_embed_dimension: int = 1536, *,
                             device="cuda") -> SimpleNetInterface:
    """A ``SimpleNetInterface`` from npz files in the JAX package's layout
    (``save_params``: flat ``/``-joined keys).  ``ckpt_root`` holds one
    ``{class}.npz`` per class, the Projection + Discriminator heads; each is
    merged over a head drawn from ``INIT_SEED``, non-strictly (unknown or
    mismatched leaves skipped with a warning).  ``backbone_path`` is the
    WideResNet-50-2 trunk, merged the same way over a trunk drawn from
    ``INIT_SEED``; without it the trunk keeps its random weights (the JAX one keeps
    its flax initialisation, which differs).  An empty root raises
    ``FileNotFoundError``."""
    from myriad_tpu_torch import checkpoint as ckpt_lib

    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(INIT_SEED)
    embedder = SimpleNetEmbedder(device=device, target_embed_dimension=target_embed_dimension)
    with torch.no_grad():
        init_simplenet_(embedder, gen)
        init_head = SimpleHead(device=device, target_embed_dimension=target_embed_dimension)
        init_simplenet_(init_head, gen)
    if backbone_path:
        tree = {"backbone": ckpt_lib.load_params(backbone_path)}
        _, skipped = ckpt_lib.merge_params(embedder, tree)
        if skipped:
            logging.warning("simplenet backbone: %d leaves skipped", len(skipped))
    heads: Dict[str, SimpleHead] = {}
    for path in sorted(glob.glob(os.path.join(ckpt_root, "*.npz"))):
        cls = os.path.splitext(os.path.basename(path))[0]
        head = SimpleHead(device=device, target_embed_dimension=target_embed_dimension)
        head.load_state_dict(init_head.state_dict(), strict=True)
        ckpt_lib.merge_params(head, ckpt_lib.load_params(path))
        heads[cls] = head
    if not heads:
        raise FileNotFoundError(f"no per-class head npz files under {ckpt_root}")
    return SimpleNetInterface(embedder, heads, map_size=map_size)


def discriminator_margin_loss(head: SimpleHead, feats: torch.Tensor, noise_std: float,
                              margin: float, generator: Optional[torch.Generator] = None, *,
                              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Hinge loss on true against Gaussian-noised features (the reference's
    training loop, threshold ``margin``).  ``noise`` is the unit normal draw,
    drawn from ``generator`` when not given."""
    if noise is None:
        noise = torch.randn(feats.shape, generator=generator, device=feats.device,
                            dtype=feats.dtype)
    noise = noise_std * noise
    true_scores = head(feats)[..., 0]
    fake_scores = head(feats + noise)[..., 0]
    return (torch.clamp(margin - true_scores, min=0.0).mean()
            + torch.clamp(margin + fake_scores, min=0.0).mean())
