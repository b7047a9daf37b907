"""The port's auction against neat_tpu's on the same masked cost matrices.

Both run the same synchronous auction with the same eps schedule and
tie-breaking, so the assignment must agree exactly (col_idx and valid).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neat_tpu.assignment.matching as jm
import neat_tpu_torch.assignment.matching as tm


def _case(seed, rows, cols, live_rows, live_cols, ties=False):
    rs = np.random.RandomState(seed)
    cost = rs.rand(rows, cols).astype(np.float32) * 50
    if ties:
        cost = np.round(cost / 10) * 10  # many equal costs
    row_mask = np.zeros(rows, bool)
    row_mask[rs.permutation(rows)[:live_rows]] = True
    col_mask = np.zeros(cols, bool)
    col_mask[rs.permutation(cols)[:live_cols]] = True
    return cost, row_mask, col_mask


@pytest.mark.parametrize(
    "seed,rows,cols,live_rows,live_cols,ties",
    [
        (0, 16, 32, 16, 32, False),   # all live, more columns
        (1, 24, 40, 10, 40, False),   # padded rows (HAWP junction padding)
        (2, 20, 12, 20, 9, False),    # more live rows than columns
        (3, 16, 32, 12, 20, True),    # tied costs
        (4, 8, 8, 5, 1, False),       # one live column: saturated bids
    ],
)
def test_auction_matches_jax(seed, rows, cols, live_rows, live_cols, ties):
    cost, rm, cm = _case(seed, rows, cols, live_rows, live_cols, ties)
    col_j, valid_j, _ = jm.auction_assignment(jnp.asarray(cost), jnp.asarray(rm), jnp.asarray(cm))
    col_t, valid_t, _ = tm.auction_assignment(torch.as_tensor(cost), torch.as_tensor(rm), torch.as_tensor(cm))
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    np.testing.assert_array_equal(col_t.numpy(), np.asarray(col_j))


def test_masked_assignment_defaults_and_unported_mode():
    cost, _, _ = _case(5, 10, 12, 10, 12)
    col_j, valid_j = jm.masked_assignment(jnp.asarray(cost))
    col_t, valid_t = tm.masked_assignment(torch.as_tensor(cost))
    np.testing.assert_array_equal(col_t.numpy(), np.asarray(col_j))
    assert valid_t.all() and np.asarray(valid_j).all()
    # the callback mode (scipy's Hungarian) is ported; an unknown mode raises as in JAX
    col_j, valid_j = jm.masked_assignment(jnp.asarray(cost), method="callback")
    col_t, valid_t = tm.masked_assignment(torch.as_tensor(cost), method="callback")
    np.testing.assert_array_equal(col_t.numpy(), np.asarray(col_j))
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    for mod, c in ((jm, jnp.asarray(cost)), (tm, torch.as_tensor(cost))):
        with pytest.raises(ValueError, match="unknown assignment method"):
            mod.masked_assignment(c, method="greedy")
