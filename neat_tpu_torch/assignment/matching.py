"""Linear assignment on the device (port of neat_tpu/assignment/matching.py).

The synchronous (Jacobi) auction of the JAX package, step for step: all
unassigned rows bid on their best column at once, each column takes the
highest bid (ties to the lowest row id) and evicts its previous owner, with
the same eps schedule (spread / (rows + 1)) and the same saturated-bid rule
for a single live column. Padded rows and columns are masked out.

The loop runs up to ``n_iters`` rounds and stops when every live row is
assigned. Once that holds a round changes nothing, so the stop test is made
every ``_CHECK_EVERY`` rounds with the same result; that test is the
loop's only host sync. ``auction_assignment.rounds`` and ``.syncs`` count
the rounds run and the host checks since they were last set to 0.

The ``callback`` mode is scipy's Hungarian on the host, as the JAX
package's ``hungarian_callback``: the masked submatrix goes to the host,
``linear_sum_assignment`` solves it, and the result comes back to the
cost's device padded as the auction's is. Each call is one host sync;
``hungarian_callback.syncs`` counts them and ``.host_s`` sums the seconds
of the host work (the solve and the padding).
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

_BIG = 1e9
_CHECK_EVERY = 16


def auction_assignment(
    cost: torch.Tensor,
    row_mask: torch.Tensor,
    col_mask: torch.Tensor,
    n_iters: int = 256,
    eps: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Jacobi auction minimizing ``cost`` (R, C) under validity masks.
    Returns (col_for_row (R,) int32, valid (R,) bool, rounds run)."""
    n_rows, n_cols = cost.shape
    dev, dt = cost.device, cost.dtype
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)
    benefit = -torch.where(col_mask[None, :], cost, torch.full_like(cost, _BIG))
    benefit = torch.where(row_mask[:, None], benefit, torch.full_like(cost, -_BIG))
    row_ids = torch.arange(n_rows, dtype=torch.int64, device=dev)

    live = torch.abs(benefit) < _BIG / 2
    lo = torch.min(torch.where(live, benefit, inf))
    hi = torch.max(torch.where(live, benefit, -inf))
    spread = torch.clamp(torch.where(torch.isfinite(hi - lo), hi - lo, 1.0), min=1e-6)
    lo = torch.where(torch.isfinite(lo), lo, 0.0)
    eps_val = spread / (n_rows + 1) if eps is None else torch.tensor(eps, dtype=dt, device=dev)

    prices = torch.zeros((n_cols,), dtype=dt, device=dev)
    owner_of_col = torch.full((n_cols,), -1, dtype=torch.int64, device=dev)
    col_of_row = torch.full((n_rows,), -1, dtype=torch.int64, device=dev)
    spare = torch.full((1,), -1, dtype=torch.int64, device=dev)

    def body(prices, owner_of_col, col_of_row):
        active = row_mask & (col_of_row < 0)
        value = benefit - prices[None, :]
        best_v = torch.max(value, dim=1).values
        best_j = torch.argmax(value, dim=1)  # first maximal index, as jnp.argmax
        active = active & (best_v > -_BIG / 2)
        value2 = value.clone()
        value2[row_ids, best_j] = -inf
        second_v = torch.max(value2, dim=1).values
        p_best = prices[best_j]
        finite2 = torch.isfinite(second_v)
        bid = torch.where(
            finite2, p_best + (best_v - second_v) + eps_val, (best_v + p_best) - lo + eps_val
        )
        bid = torch.where(active, bid, -inf)
        bid = torch.where(~finite2 & (bid <= p_best), -inf, bid)

        col_best = torch.full((n_cols,), -float("inf"), dtype=dt, device=dev)
        col_best = col_best.scatter_reduce(0, best_j, bid, reduce="amax", include_self=True)
        achieves = active & (bid >= col_best[best_j]) & torch.isfinite(bid)
        cand = torch.where(achieves, row_ids, n_rows)
        winner = torch.full((n_cols,), n_rows, dtype=torch.int64, device=dev)
        winner = winner.scatter_reduce(0, best_j, cand, reduce="amin", include_self=True)
        won = achieves & (winner[best_j] == row_ids)
        contested = torch.zeros((n_cols,), dtype=torch.int64, device=dev)
        contested = contested.scatter_reduce(
            0, best_j, won.long(), reduce="amax", include_self=True
        ).bool()

        # clear the evicted owners' columns with a fixed-shape scatter (no host
        # sync): columns that evict no one write into a spare last slot
        evict = contested & (owner_of_col >= 0)
        evict_rows = torch.where(evict, owner_of_col, n_rows)
        col_of_row = torch.cat([col_of_row, spare]).scatter(0, evict_rows, -1)[:n_rows]
        owner_of_col = torch.where(contested, winner, owner_of_col)
        prices = torch.where(contested, col_best, prices)
        col_of_row = torch.where(won, best_j, col_of_row)
        return prices, owner_of_col, col_of_row

    it = 0
    while it < n_iters:
        auction_assignment.syncs += 1
        if not bool(torch.any(row_mask & (col_of_row < 0))):
            break
        for _ in range(min(_CHECK_EVERY, n_iters - it)):
            prices, owner_of_col, col_of_row = body(prices, owner_of_col, col_of_row)
            it += 1
    auction_assignment.rounds += it
    safe_col = torch.where(col_of_row >= 0, col_of_row, 0)
    valid = row_mask & (col_of_row >= 0) & col_mask[safe_col]
    return torch.where(valid, col_of_row, 0).to(torch.int32), valid, it


auction_assignment.rounds = 0
auction_assignment.syncs = 0


def _scipy_masked_lsa(cost: np.ndarray, row_mask: np.ndarray, col_mask: np.ndarray):
    """Host-side Hungarian over the masked submatrix, padded back out:
    (col_for_row (R,) int32, valid (R,) bool), zeros where not valid."""
    from scipy.optimize import linear_sum_assignment

    rows = np.nonzero(row_mask)[0]
    cols = np.nonzero(col_mask)[0]
    col_for_row = np.zeros(cost.shape[0], dtype=np.int32)
    valid = np.zeros(cost.shape[0], dtype=bool)
    if len(rows) and len(cols):
        ri, ci = linear_sum_assignment(cost[np.ix_(rows, cols)])
        col_for_row[rows[ri]] = cols[ci].astype(np.int32)
        valid[rows[ri]] = True
    return col_for_row, valid


def hungarian_callback(
    cost: torch.Tensor, row_mask: torch.Tensor, col_mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """scipy's Hungarian on the host (a sync); the result on the cost's
    device. Returns (col_for_row (R,) int32, valid (R,) bool)."""
    host = [x.detach().cpu().numpy() for x in (cost, row_mask, col_mask)]
    hungarian_callback.syncs += 1
    t0 = time.perf_counter()
    col, valid = _scipy_masked_lsa(host[0], host[1].astype(bool), host[2].astype(bool))
    hungarian_callback.host_s += time.perf_counter() - t0
    return torch.from_numpy(col).to(cost.device), torch.from_numpy(valid).to(cost.device)


hungarian_callback.syncs = 0
hungarian_callback.host_s = 0.0


def masked_assignment(
    cost: torch.Tensor,
    row_mask: Optional[torch.Tensor] = None,
    col_mask: Optional[torch.Tensor] = None,
    method: str = "auction",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Min-cost row -> column assignment with padding masks.
    cost: (R, C). Returns (col_for_row (R,) int32, valid (R,) bool)."""
    if row_mask is None:
        row_mask = torch.ones(cost.shape[0], dtype=torch.bool, device=cost.device)
    if col_mask is None:
        col_mask = torch.ones(cost.shape[1], dtype=torch.bool, device=cost.device)
    if method == "callback":
        return hungarian_callback(cost, row_mask, col_mask)
    if method != "auction":
        raise ValueError(f"unknown assignment method: {method}")
    col, valid, _ = auction_assignment(cost, row_mask.bool(), col_mask.bool())
    return col, valid
