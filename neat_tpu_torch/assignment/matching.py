"""Linear assignment on the device (port of neat_tpu/assignment/matching.py).

The synchronous (Jacobi) auction of the JAX package, step for step: all
unassigned rows bid on their best column at once, each column takes the
highest bid (ties to the lowest row id) and evicts its previous owner, with
the same eps schedule (spread / (rows + 1)) and the same saturated-bid rule
for a single live column. Padded rows and columns are masked out.

The loop runs up to ``n_iters`` rounds and stops when every live row is
assigned. Once that holds a round changes nothing, so the stop test is made
every ``_CHECK_EVERY`` rounds with the same result; that test is the
loop's only host sync.
The scipy ``callback`` mode waits for a later slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

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
        if not bool(torch.any(row_mask & (col_of_row < 0))):
            break
        for _ in range(min(_CHECK_EVERY, n_iters - it)):
            prices, owner_of_col, col_of_row = body(prices, owner_of_col, col_of_row)
            it += 1
    safe_col = torch.where(col_of_row >= 0, col_of_row, 0)
    valid = row_mask & (col_of_row >= 0) & col_mask[safe_col]
    return torch.where(valid, col_of_row, 0).to(torch.int32), valid, it


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
    if method != "auction":
        raise NotImplementedError(
            f"assignment method {method!r} is not ported yet (ROADMAP.md §1 item 4)"
        )
    col, valid, _ = auction_assignment(cost, row_mask.bool(), col_mask.bool())
    return col, valid
