"""Set-statistic modules with parameters.

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/nn/stats.py``:
the image authenticator's pooling stat, ``MeanStdFcStat``, the Gaussian
authenticator's, ``MeanStdStat``, and the reference's other set statistics.
Each module's ``n_stats`` is its output width over the input's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from optimalstrategiesagainstgenerativeattacks_torch.nn.blocks import MLP
from optimalstrategiesagainstgenerativeattacks_torch.ops.stats import (
    custom_std,
    logvar_stat,
    mean_logvar_stat,
    mean_stat,
    mean_std_stat,
)


class MeanStat(nn.Module):
    """Mean over the set axis; n_stats = 1."""

    n_stats = 1

    def forward(self, x):
        return mean_stat(x)


class StdStat(nn.Module):
    """Safe std over the set axis; n_stats = 1."""

    n_stats = 1

    def forward(self, x):
        return custom_std(x)


class LogVarStat(nn.Module):
    """log(unbiased var + eps) over the set axis; n_stats = 1."""

    n_stats = 1

    def forward(self, x):
        return logvar_stat(x)


class MeanLogVarStat(nn.Module):
    """mean ++ log-variance over the set axis; n_stats = 2."""

    n_stats = 2

    def forward(self, x):
        return mean_logvar_stat(x)


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


class DoubleFCStat(nn.Module):
    """MLP ``stat1`` per set element, the mean over the set axis, then MLP ``stat2``."""

    def __init__(self, style_dim: int, n_stats: int = 1, hidden_layers1: Sequence[int] = (),
                 hidden_layers2: Sequence[int] = (), dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_stats = n_stats
        width = n_stats * style_dim
        self.stat1 = MLP([style_dim, *hidden_layers1, width], dtype=dtype)
        self.stat2 = MLP([width, *hidden_layers2, width], dtype=dtype)

    def forward(self, x):
        return self.stat2(mean_stat(self.stat1(x)))


class MeanStdFcStat(nn.Module):
    """mean ++ safe std ++ FC-stat over the set axis; n_stats = 2 + fc_n_stats."""

    def __init__(self, style_dim: int, fc_n_stats: int = 2,
                 fc_hidden_layers: Sequence[int] = (), dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_stats = 2 + fc_n_stats
        self.fc = FCStat(style_dim, fc_n_stats, fc_hidden_layers, dtype=dtype)

    def forward(self, x):
        return torch.cat([mean_stat(x), custom_std(x), self.fc(x)], dim=-1)
