"""The port's batched LSAP (mgsv_tpu_torch/ops/lsap.py) against JAX's
`lsap.solve_batch` and SciPy's linear_sum_assignment, on the cases of
tests/test_lsap.py: square, rectangular both ways, ties and padded
targets.  Against SciPy (the reference's matcher, which may break ties
another way) the optimal total cost is compared, atol 1e-4 as in
tests/test_lsap.py.  Both solvers run the same algorithm, the port in
float64 on the cost as it is (the shorter side as rows) and JAX in
float32 on the cost padded square with 1e6, so wherever JAX's assignment
is optimal the two are equal index for index; where JAX's float32
potentials lose the real costs' digits beside the padding, JAX misses the
optimum and the port does not (test_float64_potentials_keep_the_optimum)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from mgsv_tpu.ops import lsap as jax_lsap
from mgsv_tpu_torch.ops import lsap


def _total(cost, col_to_row):
    """(total cost of the real pairs, rows matched); a row at most once."""
    rows, total = set(), 0.0
    for j, i in enumerate(col_to_row):
        if i < cost.shape[0]:
            assert int(i) not in rows, "row matched twice"
            rows.add(int(i))
            total += cost[int(i), j]
    return total, len(rows)


def _check(costs, compared=None):
    """The port's assignment is optimal for every cost, and JAX's wherever
    JAX's is optimal (an unmatched column, any index >= R in JAX's, is R in
    the port's), in the columns `compared` marks ([B, C], default all);
    returns how many of JAX's were optimal."""
    ours = lsap.solve_batch(torch.from_numpy(costs)).numpy()
    jax_out = np.minimum(np.asarray(jax_lsap.solve_batch(jnp.asarray(costs))), costs.shape[1])
    jax_optimal = 0
    for b, (cost, c2r, j2r) in enumerate(zip(costs.astype(np.float64), ours, jax_out)):
        total, matched = _total(cost, c2r)
        ri, ci = linear_sum_assignment(cost)
        assert matched == min(cost.shape)
        np.testing.assert_allclose(total, cost[ri, ci].sum(), atol=1e-4)
        if abs(_total(cost, j2r)[0] - cost[ri, ci].sum()) <= 1e-4:
            cols = slice(None) if compared is None else compared[b]
            np.testing.assert_array_equal(c2r[cols], j2r[cols])
            jax_optimal += 1
    return jax_optimal


@pytest.mark.parametrize("shape", [(1, 1), (3, 3), (5, 5), (8, 8), (2, 5), (5, 2), (1, 4),
                                   (6, 1), (10, 1), (10, 3)])
def test_matches_jax_and_scipy(shape):
    rng = np.random.RandomState(sum(shape) * 31 + shape[0])
    costs = (rng.randn(5, *shape) * 10).astype(np.float32)
    assert _check(costs) == len(costs)         # costs of order 10: JAX keeps their digits


def test_ties_match_jax():
    """Integer costs with many equal entries: the tie-breaking (first index
    of the smallest) must be JAX's."""
    rng = np.random.RandomState(3)
    _check(rng.randint(0, 3, (8, 6, 6)).astype(np.float32))
    _check(np.zeros((2, 4, 4), np.float32))


def test_padded_targets_and_single_solve():
    """The matcher's form: invalid targets cost 1e6 (padding), and which
    row takes such a column is a tie, so only the real columns are held to
    JAX's; `solve` of one cost equals its batch of one."""
    rng = np.random.RandomState(4)
    costs = rng.randn(6, 5, 3).astype(np.float32)
    costs[:, :, 2] = 1e6
    costs[0, :, 1:] = 1e6
    _check(costs, compared=(costs != 1e6).any(axis=1))
    one = lsap.solve(torch.from_numpy(costs[1]))
    np.testing.assert_array_equal(one.numpy(), lsap.solve_batch(torch.from_numpy(costs))[1])


def test_float64_potentials_keep_the_optimum():
    """Ten queries, one target: the optimum is the cheapest row (7, cost
    0.10).  JAX pads the cost to 10 x 10 with 1e6, its potentials reach
    about 9e6, where float32 steps by 1, and its solver takes row 1 (0.11);
    the port solves the one-row transpose in float64 and takes row 7, as
    SciPy does."""
    cost = np.array([[0.16], [0.11], [0.66], [0.14], [0.20], [0.37], [0.82], [0.10], [0.84],
                     [0.10]], np.float32)
    ri, ci = linear_sum_assignment(cost)
    assert ri.tolist() == [7] and ci.tolist() == [0]
    assert lsap.solve(torch.from_numpy(cost)).tolist() == [7]
    assert np.asarray(jax_lsap.solve(jnp.asarray(cost))).tolist() == [1]


def test_identity_on_diagonal_favoring_matrix():
    cost = torch.eye(5) * -100.0
    np.testing.assert_array_equal(lsap.solve(cost).numpy(), np.arange(5))
