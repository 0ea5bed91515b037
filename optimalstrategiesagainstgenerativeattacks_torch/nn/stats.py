"""Set-statistic modules with parameters.

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/nn/stats.py``
for the image authenticator's pooling stat, ``MeanStdFcStat``, and the
Gaussian authenticator's, ``MeanStdStat`` (no parameters).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from optimalstrategiesagainstgenerativeattacks_torch.nn.blocks import MLP
from optimalstrategiesagainstgenerativeattacks_torch.ops.stats import (
    custom_std,
    mean_stat,
    mean_std_stat,
)


class MeanStdStat(nn.Module):
    """mean ++ safe std over the set axis; n_stats = 2."""

    n_stats = 2

    def forward(self, x):
        return mean_std_stat(x)


class FCStat(nn.Module):
    """MLP per set element, then the mean over the set axis."""

    def __init__(self, style_dim: int, n_stats: int = 1, hidden_layers: Sequence[int] = (),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.stat = MLP([style_dim, *hidden_layers, n_stats * style_dim], dtype=dtype)

    def forward(self, x):
        return mean_stat(self.stat(x))


class MeanStdFcStat(nn.Module):
    """mean ++ safe std ++ FC-stat over the set axis; n_stats = 2 + fc_n_stats."""

    def __init__(self, style_dim: int, fc_n_stats: int = 2,
                 fc_hidden_layers: Sequence[int] = (), dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_stats = 2 + fc_n_stats
        self.fc = FCStat(style_dim, fc_n_stats, fc_hidden_layers, dtype=dtype)

    def forward(self, x):
        return torch.cat([mean_stat(x), custom_std(x), self.fc(x)], dim=-1)
