"""The (dp, mp) mesh of a torch.distributed run and its collectives; the
twin of mgsv_tpu/core/mesh.py.

JAX runs one SPMD program over a (dp, mp) device mesh: the batch is split
by rows over dp and replicated over mp, and XLA inserts the collectives.
The port runs one process a rank (core/dist.py) and the model replicated,
so a `Mesh` here is the run's dp * mp ranks, placed as JAX's np.reshape
places devices (mgsv_tpu/core/mesh.py:23-43): rank k is at
(dp_index, mp_index) = (k // mp, k % mp).  Its two process groups:
`dp_group`, the ranks that share mp_index, over which the rows split, and
`mp_group`, the ranks that share dp_index.  At mp = 1 `dp_group` is the
default group and no group is made.  The collectives are explicit:

- `gather_rows`: every rank's rows of a tensor, in axis order, on every
  rank of an axis group (dp by default).  Under autograd its backward is a
  reduce-scatter: each rank's rows receive the sum over the group of the
  gradients taken from them.
- `all_reduce_sum`: the sum over the dp group, on every rank of it; its
  backward is the same sum of the gradients.
- `sync_gradients`: the per-rank partial gradients summed in place over
  the dp group, one flat all-reduce.

The rule that makes the sum of the ranks' gradients the gradient of the
global loss: the ranks' objectives must add up, over a dp group, to the
global loss.  A per-row term is this rank's rows' share of the global
mean, and a term every rank computes whole from gathered rows (the
retrieval losses over the [V, M] matrix) enters each rank's objective
divided by dp.

The model axis: the work of training is replicated over mp.  The mp
replicas of a dp index take the same rows and fold the same dp index into
their dropout seeds (`fold_axis_into_seed`), so they draw the same masks
and keep bit-identical weights.  Only the evaluation's 2-D similarity
(eval/similarity.py::xpool_similarity_sharded_2d) and the engine's index
under mesh_axis "mp" (serve/engine.py) divide work over mp.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from mgsv_tpu_torch.core.device import check_mesh_shape

DATA_AXIS = "dp"
MODEL_AXIS = "mp"
SEED_FOLD = 1000003          # JAX's fold_axis_into_seed multiplier


@dataclasses.dataclass(frozen=True)
class Mesh:
    """dp * mp ranks of the default process group, one process each; `rank`
    is this process's.  dp_group / mp_group: this rank's groups of each
    axis (None: the default group, at mp = 1 for dp; no group, for mp).
    Two meshes are equal when their shape and rank are."""

    dp: int
    rank: int
    mp: int = 1
    dp_group: Optional[Any] = dataclasses.field(default=None, compare=False, repr=False)
    mp_group: Optional[Any] = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.dp, MODEL_AXIS: self.mp}

    @property
    def dp_index(self) -> int:
        return self.rank // self.mp

    @property
    def mp_index(self) -> int:
        return self.rank % self.mp

    def index(self, axis: str) -> int:
        """This rank's position along `axis`."""
        return {DATA_AXIS: self.dp_index, MODEL_AXIS: self.mp_index}[axis]

    def group(self, axis: str):
        return {DATA_AXIS: self.dp_group, MODEL_AXIS: self.mp_group}[axis]

    def takes_collectives(self, axis: str) -> bool:
        """False for the mp axis at mp = 1, which has no group: a gather or a
        sum over it is the tensor itself."""
        return axis == DATA_AXIS or self.mp > 1


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
    1 x 1) for `shape` (dp, mp), checked and resolved by
    core/device.py::check_mesh_shape.  At mp > 1 it makes the mp dp
    groups (dp ranks each) and the dp mp groups (mp ranks each) with
    `dist.new_group`: every rank makes every group, in the same order, as
    new_group requires, and keeps its own."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    dp, mp = check_mesh_shape(shape, world)
    if mp == 1:
        return Mesh(dp=dp, rank=rank)
    dp_group = mp_group = None
    for j in range(mp):                  # the ranks that share mp_index j
        group = dist.new_group([i * mp + j for i in range(dp)])
        if rank % mp == j:
            dp_group = group
    for i in range(dp):                  # the ranks that share dp_index i
        group = dist.new_group([i * mp + j for j in range(mp)])
        if rank // mp == i:
            mp_group = group
    return Mesh(dp=dp, rank=rank, mp=mp, dp_group=dp_group, mp_group=mp_group)


def fold_axis_into_seed(seed: int, dp_index: int) -> int:
    """A seed decorrelated across the dp axis: seed + dp_index * 1000003,
    as JAX's fold_axis_into_seed (mgsv_tpu/core/mesh.py:45-60); dp index 0
    keeps the seed, and the mp replicas of a dp index share it."""
    return seed + dp_index * SEED_FOLD


def process_local_rows(n_rows: int, mesh: Mesh) -> np.ndarray:
    """The global rows of an [n_rows, ...] batch this rank owns, ascending:
    the dp index's contiguous block of n_rows / dp (the mp replicas own the
    same block)."""
    if n_rows % mesh.dp:
        raise ValueError(f"a batch of {n_rows} rows does not split over {mesh.dp} ranks")
    per = n_rows // mesh.dp
    return np.arange(mesh.dp_index * per, (mesh.dp_index + 1) * per)


def local_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the rows of a global tensor (its dp index's)."""
    per = x.shape[0] // mesh.dp
    return x[mesh.dp_index * per:(mesh.dp_index + 1) * per]


def _all_gather(x: torch.Tensor, n: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, n: int, group) -> torch.Tensor:
        ctx.n, ctx.group = n, group
        return _all_gather(x, n, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous()
        out = torch.empty((grad.shape[0] // ctx.n,) + grad.shape[1:], dtype=grad.dtype,
                          device=grad.device)
        dist.reduce_scatter(out, list(grad.chunk(ctx.n)), group=ctx.group)
        return out, None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def gather_rows(x: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS) -> torch.Tensor:
    """[rows, ...] on each rank -> [n * rows, ...] over the n ranks of this
    rank's `axis` group, index 0's rows first, on every rank of the group;
    differentiable (backward: reduce-scatter)."""
    if not mesh.takes_collectives(axis):
        return x
    n, group = mesh.shape[axis], mesh.group(axis)
    if x.requires_grad:
        return _GatherRows.apply(x, n, group)
    return _all_gather(x, n, group)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS) -> torch.Tensor:
    """The sum of x over this rank's `axis` group (dp by default), on every
    rank of it; differentiable."""
    if not mesh.takes_collectives(axis):
        return x
    group = mesh.group(axis)
    if x.requires_grad:
        return _AllReduceSum.apply(x, group)
    y = x.clone()
    dist.all_reduce(y, group=group)
    return y


def sync_gradients(tensors: List[torch.Tensor], mesh: Mesh) -> int:
    """Sum each tensor over the dp group, in place, through one flat float32
    buffer and one all-reduce; returns the bytes reduced.  Every rank must
    pass the same shapes in the same order."""
    if not tensors:
        return 0
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.dp_group)
    torch._foreach_copy_(tensors, [v.view_as(t) for v, t in
                                   zip(flat.split([t.numel() for t in tensors]), tensors)])
    return flat.numel() * flat.element_size()
