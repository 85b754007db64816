"""EmbeddingNet, the MLP + BatchNorm aggregator of agg_module="mlp", ported
from mgsv_tpu/models/embedding_net.py:

    Linear(d -> 1024) -> BatchNorm(L) -> ReLU -> Linear(1024 -> d)
        -> BatchNorm(L, momentum 0.99) -> ReLU -> Linear(d -> d)

Each BatchNorm's channels are the sequence positions: it normalizes one
position over (batch, feature) of the [B, L, D] input, as torch's
BatchNorm1d(L) does on it.  Parameters and buffers carry the reference
Sequential's names (`net.0`, `net.1`, `net.3`, `net.4`, `net.6`; the
BatchNorms' `running_mean` and `running_var`, no `num_batches_tracked`,
which JAX does not keep).

A training call normalizes with the batch's biased variance and folds the
batch statistics into the running buffers, running = (1 - momentum) running
+ momentum batch, with the unbiased variance (n = B * D); every other call
normalizes with the running buffers.  The caller says which (`training`):
the port's steps tell training from evaluation by the dropout generator
they pass, never by `module.training`.  The module computes in float32
outside any autocast, as JAX's, whose Dense layers take no dtype.

Over a data-parallel mesh (core/mesh.py) a training call normalizes with
the global batch's statistics, as JAX's, whose mean spans the dp axis: the
moments are all-reduced (the mean, then the centred second moment, each a
differentiable sum over the ranks), so every rank normalizes alike and
keeps identical running buffers.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mgsv_tpu_torch.core.mesh import Mesh, all_reduce_sum
from mgsv_tpu_torch.models.layers import widen, xavier_normal_

HIDDEN = 1024
EPS = 1e-5
MOMENTUM1 = 0.1     # torch BatchNorm1d's default (model_Base.py:224)
MOMENTUM2 = 0.99    # explicit in the reference (model_Base.py:228)


class PositionBatchNorm(nn.Module):
    """BatchNorm over the positions of [B, L, D]: weight, bias and running
    buffers of shape [L]."""

    def __init__(self, length: int, momentum: float, eps: float = EPS):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(length))
        self.bias = nn.Parameter(torch.zeros(length))
        self.register_buffer("running_mean", torch.zeros(length))
        self.register_buffer("running_var", torch.ones(length))

    @torch.no_grad()
    def reset_parameters(self) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, training: bool,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
        if not training or mesh is None or mesh.dp == 1:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, training=training, momentum=self.momentum,
                                eps=self.eps)
        # the global batch's moments per position, over (rows of every rank, D)
        n = x.shape[0] * x.shape[2] * mesh.dp
        mean = all_reduce_sum(x.sum(dim=(0, 2)), mesh) / n
        centred = x - mean[None, :, None]
        var = all_reduce_sum((centred * centred).sum(dim=(0, 2)), mesh) / n
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.detach() * (n / (n - 1)), alpha=m)
        scale = self.weight * torch.rsqrt(var + self.eps)
        return centred * scale[None, :, None] + self.bias[None, :, None]


class EmbeddingNet(nn.Module):
    """x [B, L, D] -> [B, L, D] for the one sequence length L it is built
    for (the tower's frames or snippets, one more with the cls token)."""

    def __init__(self, dim: int, length: int, hidden: int = HIDDEN):
        super().__init__()
        self.length = length
        self.net = nn.Sequential(nn.Linear(dim, hidden), PositionBatchNorm(length, MOMENTUM1),
                                 nn.ReLU(), nn.Linear(hidden, dim),
                                 PositionBatchNorm(length, MOMENTUM2), nn.ReLU(),
                                 nn.Linear(dim, dim))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """JAX's init: xavier-normal weights, biases of 0.01, unit BatchNorms
        with zero means and unit variances."""
        for i in (0, 3, 6):
            xavier_normal_(self.net[i].weight, generator)
            self.net[i].bias.fill_(0.01)
        for i in (1, 4):
            self.net[i].reset_parameters()

    def forward(self, x: torch.Tensor, training: bool = False,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
        """training: normalize with the batch's statistics (the global
        batch's over `mesh`) and update the running buffers; else normalize
        with the buffers."""
        if x.dim() != 3 or x.shape[1] != self.length:
            raise ValueError(f"EmbeddingNet built for sequences of {self.length}, given "
                             f"{tuple(x.shape)}")
        net = self.net
        with torch.autocast(x.device.type, enabled=False):
            h = torch.relu(net[1](net[0](widen(x)), training, mesh))
            h = torch.relu(net[4](net[3](h), training, mesh))
            return net[6](h)
