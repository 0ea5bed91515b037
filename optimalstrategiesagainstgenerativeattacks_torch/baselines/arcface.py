"""ArcFace baseline authenticator: SE-IR ResNet backbone + angular-margin head.

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/baselines/arcface.py``
(parity with the reference's ``baselines/arcface/models.py``): SE module
(:22-38), bottleneck_IR / bottleneck_IR_SE (:41-86), 50/100/152-layer block
specs (:89-117), ``Backbone`` (:120-164) with the img-size-dependent output
head, additive-angular-margin head (s=64, m=0.5, :170-208), and
``predict(x1, x2)`` = -||emb1 - emb2||^2 against a threshold (:231-237).

Images enter as [B, H, W, C] and run as NCHW.  BatchNorm and PReLU follow
Flax (``baselines/layers.py``); the backbone's last map is flattened in the
JAX package's NHWC order before ``out_dense``; dropout draws from the
generator the caller passes.  The head's ``weight`` is [classes, emb], the
transpose of the JAX package's kernel, as every dense weight here is.
``bn_axis_name="data"`` (the JAX package's cross-replica statistics) syncs
every BatchNorm's statistics over the mesh's data axis
(``baselines/layers.py``); the default, None, takes each rank's own.  No
trainer passes it, in the JAX package neither.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from optimalstrategiesagainstgenerativeattacks_torch.baselines.layers import (
    BatchNorm,
    Conv,
    Dense,
    PReLU,
)
from optimalstrategiesagainstgenerativeattacks_torch.baselines.siamese import flatten_nhwc
from optimalstrategiesagainstgenerativeattacks_torch.nn.init import uniform_pm1_
from optimalstrategiesagainstgenerativeattacks_torch.ops.image_ops import to_nchw


def l2_norm(x: torch.Tensor, axis: int = 1) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=axis, keepdim=True)


class SEModule(nn.Module):
    """Squeeze-and-excitation gate (``SEModule:22-38``)."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = Conv(channels, channels // reduction, 1, bias=False)
        self.fc2 = Conv(channels // reduction, channels, 1, bias=False)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(s))))


class BottleneckIR(nn.Module):
    """IR residual unit (``bottleneck_IR:41-58``); optional SE gate."""

    def __init__(self, in_channels: int, depth: int, stride: int, use_se: bool = False,
                 bn_axis_name: Optional[str] = None):
        super().__init__()
        self.stride = stride
        self.project = in_channels != depth
        if self.project:
            self.shortcut_conv = Conv(in_channels, depth, 1, stride=stride, bias=False)
            self.shortcut_bn = BatchNorm(depth, axis_name=bn_axis_name)
        self.bn1 = BatchNorm(in_channels, axis_name=bn_axis_name)
        self.conv1 = Conv(in_channels, depth, 3, padding=1, bias=False)
        self.prelu = PReLU(depth)
        self.conv2 = Conv(depth, depth, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm(depth, axis_name=bn_axis_name)
        self.se = SEModule(depth) if use_se else None

    def forward(self, x):
        if self.project:
            shortcut = self.shortcut_bn(self.shortcut_conv(x))
        else:  # a 1x1 max pool with this stride
            shortcut = x[:, :, ::self.stride, ::self.stride]
        res = self.bn2(self.conv2(self.prelu(self.conv1(self.bn1(x)))))
        if self.se is not None:
            res = self.se(res)
        return res + shortcut


def get_blocks(num_layers: int) -> Sequence[Sequence[Tuple[int, int]]]:
    """(depth, stride) unit specs for 50/100/152 layers (``get_blocks:100-117``)."""
    if num_layers == 50:
        units = [3, 4, 14, 3]
    elif num_layers == 100:
        units = [3, 13, 30, 3]
    elif num_layers == 152:
        units = [3, 8, 36, 3]
    else:
        raise ValueError("num_layers should be 50, 100, or 152")
    depths = [64, 128, 256, 512]
    return [[(depth, 2)] + [(depth, 1)] * (n - 1) for depth, n in zip(depths, units)]


class Backbone(nn.Module):
    """SE-IR ResNet embedding backbone (``Backbone:120-164``)."""

    def __init__(self, num_layers: int = 50, drop_ratio: float = 0.6, mode: str = "ir_se",
                 img_size: int = 64, img_channels: int = 3, emb_dim: int = 512,
                 bn_axis_name: Optional[str] = None):
        super().__init__()
        if mode not in ("ir", "ir_se"):
            raise ValueError("mode should be ir or ir_se")
        if img_size == 64:
            last_img_size = 4
        elif img_size == 32:
            last_img_size = 2
        else:
            raise ValueError("img_size must be 32 or 64")
        self.drop_ratio = drop_ratio
        self.input_conv = Conv(img_channels, 64, 3, padding=1, bias=False)
        self.input_bn = BatchNorm(64, axis_name=bn_axis_name)
        self.input_prelu = PReLU(64)
        in_ch = 64
        self.units = []
        for bi, block in enumerate(get_blocks(num_layers)):
            for ui, (depth, stride) in enumerate(block):
                name = f"block{bi}_unit{ui}"
                setattr(self, name, BottleneckIR(in_ch, depth, stride, use_se=mode == "ir_se",
                                                 bn_axis_name=bn_axis_name))
                self.units.append(name)
                in_ch = depth
        self.out_bn = BatchNorm(512, axis_name=bn_axis_name)
        self.out_dense = Dense(512 * last_img_size * last_img_size, emb_dim)
        self.out_bn1d = BatchNorm(emb_dim, axis_name=bn_axis_name)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        h = self.input_prelu(self.input_bn(self.input_conv(to_nchw(x))))
        for name in self.units:
            h = getattr(self, name)(h)
        h = self.out_bn(h)
        if self.training and self.drop_ratio > 0:
            keep = 1.0 - self.drop_ratio
            mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
            h = torch.where(mask, h / keep, torch.zeros_like(h))
        h = self.out_bn1d(self.out_dense(flatten_nhwc(h)))
        return l2_norm(h.float())


class ArcfaceHead(nn.Module):
    """Additive-angular-margin softmax head (``ArcfaceHead:170-208``)."""

    def __init__(self, embedding_size: int = 512, classnum: int = 51332, s: float = 64.0,
                 m: float = 0.5):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(classnum, embedding_size))
        self.classnum = classnum
        self.s, self.m = s, m
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        uniform_pm1_(self.weight, generator)

    def forward(self, embeddings, label):
        cos_m, sin_m = math.cos(self.m), math.sin(self.m)
        mm = sin_m * self.m
        threshold = math.cos(math.pi - self.m)
        cos_theta = torch.clamp(embeddings @ l2_norm(self.weight, axis=1).t(), -1.0, 1.0)
        sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta**2, min=0.0))
        cos_theta_m = cos_theta * cos_m - sin_theta * sin_m
        # keep theta+m within [0, pi]: fall back to cosface beyond it
        cos_theta_m = torch.where(cos_theta - threshold <= 0, cos_theta - mm, cos_theta_m)
        target = F.one_hot(label.long(), self.classnum) > 0
        return torch.where(target, cos_theta_m, cos_theta) * self.s


class ArcFace(nn.Module):
    """Backbone + margin head with verification ``predict`` (``ArcFace:213-237``)."""

    def __init__(self, emb_model: Backbone, embedding_size: int, n_classes: int,
                 th: float = 1.5):
        super().__init__()
        self.emb_model = emb_model
        self.head = ArcfaceHead(embedding_size=embedding_size, classnum=n_classes)
        self.th = th

    def forward(self, x, label, generator: Optional[torch.Generator] = None):
        emb = self.emb_model(x, generator)
        return emb, self.head(emb, label)

    def embed(self, x):
        return self.emb_model(x)

    def predict(self, x1, x2):
        score = -(self.emb_model(x1) - self.emb_model(x2)).square().sum(dim=1)
        return score, score >= self.th
