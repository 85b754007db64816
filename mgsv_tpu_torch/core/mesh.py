"""The data-parallel mesh of a torch.distributed run and its collectives;
the twin of mgsv_tpu/core/mesh.py.

JAX runs one SPMD program over a (dp, mp) device mesh: the batch is split
by rows over dp and XLA inserts the collectives.  The port runs one
process a rank (core/dist.py) and the model replicated, so a `Mesh` here
is the run's dp ranks, and the collectives are explicit:

- `gather_rows`: every rank's rows of a tensor, in rank order, on every
  rank.  Under autograd its backward is a reduce-scatter: each rank's
  rows receive the sum over ranks of the gradients taken from them.
- `all_reduce_sum`: the sum over ranks, on every rank; its backward is the
  same sum of the gradients.
- `sync_gradients`: the per-rank partial gradients summed in place, one
  flat all-reduce.

The rule that makes the sum of the ranks' gradients the gradient of the
global loss: the ranks' objectives must add up to the global loss.  A
per-row term is this rank's rows' share of the global mean, and a term
every rank computes whole from gathered rows (the retrieval losses over
the [V, M] matrix) enters each rank's objective divided by dp.

`model axis`: JAX's mp axis serves only the 2-D evaluation similarity, which
is not ported; a mesh here has mp = 1.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from mgsv_tpu_torch.core.device import check_mesh_shape

DATA_AXIS = "dp"
MODEL_AXIS = "mp"
SEED_FOLD = 1000003          # JAX's fold_axis_into_seed multiplier


@dataclasses.dataclass(frozen=True)
class Mesh:
    """dp ranks of the default process group, one process each; `rank` is
    this process's."""

    dp: int
    rank: int

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.dp, MODEL_AXIS: 1}


def check_mesh(mesh) -> None:
    """Raise for a mesh that is not a `Mesh` (one process a rank), such as
    JAX's device mesh, one process over several devices, which the port
    does not run."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise NotImplementedError(
            f"mesh {type(mesh).__name__}: the port runs one process a rank "
            "(core.mesh.Mesh over torch.distributed); one process over several devices, as "
            "a JAX device mesh, is not ported (ROADMAP.md, queue 1: multi-GPU, one process "
            "over several devices)")


def make_mesh(shape: Sequence[int] = (-1, 1)) -> Mesh:
    """The mesh of the initialized process group (one process, no group:
    dp = 1) for `shape` (dp, mp): dp -1 or 1 and the group's size both mean
    every rank; see core/device.py::check_mesh_shape."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    check_mesh_shape(shape, world)
    return Mesh(dp=world, rank=dist.get_rank() if dist.is_initialized() else 0)


def fold_axis_into_seed(seed: int, rank: int) -> int:
    """A seed decorrelated across ranks: seed + rank * 1000003, as JAX's
    fold_axis_into_seed (mgsv_tpu/core/mesh.py:45-60); rank 0 keeps the
    seed."""
    return seed + rank * SEED_FOLD


def process_local_rows(n_rows: int, mesh: Mesh) -> np.ndarray:
    """The global rows of an [n_rows, ...] batch this rank owns, ascending:
    the rank's contiguous block of n_rows / dp."""
    if n_rows % mesh.dp:
        raise ValueError(f"a batch of {n_rows} rows does not split over {mesh.dp} ranks")
    per = n_rows // mesh.dp
    return np.arange(mesh.rank * per, (mesh.rank + 1) * per)


def local_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the rows of a global tensor."""
    per = x.shape[0] // mesh.dp
    return x[mesh.rank * per:(mesh.rank + 1) * per]


def _all_gather(x: torch.Tensor, dp: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dp)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, dp: int) -> torch.Tensor:
        ctx.dp = dp
        return _all_gather(x, dp)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous()
        out = torch.empty((grad.shape[0] // ctx.dp,) + grad.shape[1:], dtype=grad.dtype,
                          device=grad.device)
        dist.reduce_scatter(out, list(grad.chunk(ctx.dp)))
        return out, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[rows, ...] on each rank -> [dp * rows, ...], rank 0's rows first, on
    every rank; differentiable (backward: reduce-scatter)."""
    if x.requires_grad:
        return _GatherRows.apply(x, mesh.dp)
    return _all_gather(x, mesh.dp)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of x over the ranks, on every rank; differentiable."""
    if x.requires_grad:
        return _AllReduceSum.apply(x)
    y = x.clone()
    dist.all_reduce(y)
    return y


def sync_gradients(tensors: List[torch.Tensor], mesh: Mesh) -> int:
    """Sum each tensor over the ranks, in place, through one flat float32
    buffer and one all-reduce; returns the bytes reduced.  Every rank must
    pass the same shapes in the same order."""
    if not tensors:
        return 0
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    torch._foreach_copy_(tensors, [v.view_as(t) for v, t in
                                   zip(flat.split([t.numel() for t in tensors]), tensors)])
    return flat.numel() * flat.element_size()
