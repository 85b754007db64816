"""Batched exact linear sum assignment, ported from mgsv_tpu/ops/lsap.py.

The same shortest-augmenting-path algorithm (the Jonker-Volgenant / e-maxx
formulation that SciPy's linear_sum_assignment implements), written as
batched torch ops on the cost's device: every sample of the batch runs the
same fixed number of steps, a sample whose path is complete masks its
updates, and nothing is read back to the host, so a training step that
matches its queries never waits for the card.  Problem sizes are tiny
(#queries x #targets, both at most ~16).

The fixed bounds are exact: when row i is added, rows 0..i-1 hold columns,
so the search visits at most i of them (plus the virtual column) before it
reaches a free one, and the augmenting path it unwinds has at most i + 1
hops.  Row i therefore takes i + 1 search steps and i + 1 unwind steps.

Two choices differ from the JAX package, neither in the result:

* A rectangular cost is solved with its shorter side as the rows, as SciPy
  does, where JAX pads it square with a constant.  The algorithm takes
  rows <= columns as it is, and the work grows with the rows: the matcher's
  usual cost, Q queries by one target, is one row and one search step in
  place of Q rows and Q(Q + 1)/2 steps.
* The costs and potentials are float64, where JAX keeps them in float32.
  The matcher gives an invalid target a cost of 1e6, and JAX's square
  padding every missing row or column too, so the potentials grow to
  millions, where float32 keeps steps of 0.25 to 1: the real costs' digits
  (differences of order 0.1) are lost, and JAX's solver can miss the
  optimum SciPy finds (tests/test_torch_port_lsap.py shows such a cost).
  In float64 they are kept; where JAX's assignment is optimal the two
  agree, ties broken alike (the first smallest column).
"""

from __future__ import annotations

import torch

_INF = 1e30


def _solve(cost: torch.Tensor) -> torch.Tensor:
    """Exact LSAP on [B, n, m] costs with n <= m: every row gets a column.
    Returns col_to_row [B, m] int64, -1 for a column no row took (costs
    must be finite)."""
    bsz, n, m = cost.shape
    dev, dt = cost.device, torch.float64
    cost = cost.to(dt)
    rows = torch.arange(bsz, device=dev)
    # u: row potentials (slot n = scratch), v: column potentials (slot m =
    # the virtual column), p: column -> row (-1 free; p[m] = the new row)
    u = torch.zeros(bsz, n + 1, dtype=dt, device=dev)
    v = torch.zeros(bsz, m + 1, dtype=dt, device=dev)
    p = torch.full((bsz, m + 1), -1, dtype=torch.int64, device=dev)
    virtual = torch.full((bsz,), m, dtype=torch.int64, device=dev)
    for i in range(n):
        p[:, m] = i
        j0 = virtual
        minv = torch.full((bsz, m + 1), _INF, dtype=dt, device=dev)
        way = torch.zeros(bsz, m + 1, dtype=torch.int64, device=dev)
        used = torch.zeros(bsz, m + 1, dtype=torch.bool, device=dev)
        active = torch.ones(bsz, dtype=torch.bool, device=dev)
        for _ in range(i + 1):
            i0 = p[rows, j0]
            active = active & (i0 != -1)
            used = used | (torch.nn.functional.one_hot(j0, m + 1).bool() & active[:, None])
            i0 = i0.clamp(min=0)
            cur = cost[rows, i0] - u[rows, i0][:, None] - v[:, :m]
            better = ~used[:, :m] & (cur < minv[:, :m]) & active[:, None]
            minv[:, :m] = torch.where(better, cur, minv[:, :m])
            way[:, :m] = torch.where(better, j0[:, None], way[:, :m])
            masked = torch.where(used[:, :m], _INF, minv[:, :m])
            j1 = masked.argmin(dim=1)
            delta = torch.where(active, masked[rows, j1], 0.0)[:, None]
            # used columns' rows gain delta, used columns lose it, unused
            # columns' tentative distances shrink by it
            row_idx = torch.where(used, p, n)
            u = u.scatter_add(1, row_idx, torch.where(used, delta, 0.0))
            v = v - torch.where(used, delta, 0.0)
            minv = minv - torch.where(used, 0.0, delta)
            j0 = torch.where(active, j1, j0)
        # unwind the augmenting path back to the virtual column
        done = j0 == m
        for _ in range(i + 1):
            j1 = way[rows, j0]
            take = ~done
            p_new = p.clone()
            p_new[rows, j0] = p[rows, j1]
            p = torch.where(take[:, None], p_new, p)
            j0 = torch.where(take, j1, j0)
            done = done | (j0 == m)
    return p[:, :m]


def solve_batch(cost: torch.Tensor) -> torch.Tensor:
    """LSAP of each [R, C] cost of a [B, R, C] batch: min(R, C) pairs of
    least total cost.  Returns col_to_row [B, C] int64, R where a column
    is unmatched (JAX's solver gives such a column some index >= R)."""
    bsz, r, c = cost.shape
    if r <= c:
        c2r = _solve(cost)
        return torch.where(c2r < 0, r, c2r)
    # more rows than columns: solve the transpose, whose rows are the
    # columns, and invert its row -> column map
    r2c = _solve(cost.transpose(1, 2))                            # [B, R]: a column or -1
    out = torch.full((bsz, c + 1), r, dtype=torch.int64, device=cost.device)
    rows = torch.arange(r, device=cost.device).expand(bsz, r)
    return out.scatter(1, torch.where(r2c < 0, c, r2c), rows)[:, :c]


def solve(cost: torch.Tensor) -> torch.Tensor:
    """One [R, C] cost: `solve_batch` of a batch of one -> col_to_row [C]."""
    return solve_batch(cost[None])[0]
