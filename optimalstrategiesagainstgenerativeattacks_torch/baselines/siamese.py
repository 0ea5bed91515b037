"""Siamese baseline authenticator (protonet encoder + abs-diff classifier).

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/baselines/siamese.py``
(parity with the reference's ``baselines/siamese/models.py``): the 4-block
conv-BN-ReLU-maxpool protonet encoder (:14-56), the simple embedding nets
(:59-95), and ``SiameseNet`` with encode / classify(|e1-e2|) / forward
(:97-114).  Images enter as [B, H, W, C] and run as NCHW; an embedding is
flattened in the JAX package's NHWC order, so the classifier's weights
carry across unchanged.  Train and eval mode are the module's own
(``.train()`` / ``.eval()``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from optimalstrategiesagainstgenerativeattacks_torch.baselines.layers import (
    BatchNorm,
    Conv,
    Dense,
    PReLU,
)
from optimalstrategiesagainstgenerativeattacks_torch.ops.image_ops import to_nchw


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> [B, H*W*C] in NHWC order (a view for channels_last memory)."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class ProtonetEmbeddingNet(nn.Module):
    """4x [conv3x3 -> BN -> ReLU -> maxpool2] (``ProtonetEmbeddingNet:14-56``)."""

    def __init__(self, inp_n_channels: int, inp_img_size: int, hidden_dim: int = 64,
                 z_dim: int = 64):
        super().__init__()
        self.inp_img_size = inp_img_size
        self.z_dim = z_dim
        dims = [inp_n_channels, hidden_dim, hidden_dim, hidden_dim, z_dim]
        for i in range(4):
            setattr(self, f"conv{i}", Conv(dims[i], dims[i + 1], 3, padding=1))
            setattr(self, f"bn{i}", BatchNorm(dims[i + 1]))

    @property
    def embedding_dim(self) -> int:
        out_img_size = self.inp_img_size // (2**4)
        return self.z_dim * out_img_size * out_img_size

    def forward(self, x):
        x = to_nchw(x)
        for i in range(4):
            x = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x))
            x = F.max_pool2d(F.relu(x), 2)
        return flatten_nhwc(x)


class SimpleEmbeddingNet(nn.Module):
    """conv5-PReLU-pool x2 -> 3-layer MLP head (``SimpleEmbeddingNet:59-77``)."""

    def __init__(self, inp_n_channels: int = 1, inp_img_size: int = 28):
        super().__init__()
        self.conv1 = Conv(inp_n_channels, 32, 5)
        self.prelu1 = PReLU(32)
        self.conv2 = Conv(32, 64, 5)
        self.prelu2 = PReLU(64)
        side = ((inp_img_size - 4) // 2 - 4) // 2
        self.fc1 = Dense(64 * side * side, 256)
        self.prelu3 = PReLU(256)
        self.fc2 = Dense(256, 256)
        self.prelu4 = PReLU(256)
        self.fc3 = Dense(256, 2)

    def forward(self, x):
        x = F.max_pool2d(self.prelu1(self.conv1(to_nchw(x))), 2)
        x = F.max_pool2d(self.prelu2(self.conv2(x)), 2)
        x = self.prelu3(self.fc1(flatten_nhwc(x)))
        x = self.prelu4(self.fc2(x))
        return self.fc3(x)


class SimpleEmbeddingNetL2(SimpleEmbeddingNet):
    """L2-normalised variant (``SimpleEmbeddingNetL2:80-89``)."""

    def forward(self, x):
        out = super().forward(x)
        return out / out.square().sum(dim=1, keepdim=True).sqrt()


class SiameseNet(nn.Module):
    """encode / classify(|e1 - e2|) / forward (``SiameseNet:97-114``)."""

    def __init__(self, embedding_net: nn.Module, embedding_dim: int):
        super().__init__()
        self.embedding_net = embedding_net
        self.fc = Dense(embedding_dim, 1)

    def encode(self, x):
        return self.embedding_net(x)

    def classify(self, emb1, emb2):
        return self.fc((emb1 - emb2).abs())

    def forward(self, x1, x2):
        return self.classify(self.encode(x1), self.encode(x2))
