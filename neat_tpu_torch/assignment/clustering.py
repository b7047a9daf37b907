"""DBSCAN junction proposals on the device (port of dbscan_cluster_means of
neat_tpu/assignment/clustering.py).

The reference clusters the detached 3D line endpoints of a step with
sklearn's DBSCAN (eps 0.01, min_samples 2) on the host. With min_samples 2,
DBSCAN is exactly this: drop the points with no eps-neighbour, then take
the connected components of the eps-ball graph. For the step's 2048
endpoints the dense (N, N) graph is 4M entries, so the components are found
on the device by min-label propagation with pointer jumping over it, in
plain tensor operations.

The JAX loop stops when an iteration changes no label, or after
``max_prop_iters`` iterations. An iteration that changes nothing changes
nothing ever after, so the labels are the same wherever the loop stops at
or after that point, up to the cap. This loop runs ``check_every``
iterations between two host checks of the last iteration's change; those
checks are its only host syncs.

The output is padded as in JAX: the mean of a cluster sits at the row of
its lowest member index, with a valid mask. The sums are masked (N, N)
reductions, not a scatter: the same inputs give the same bits on every run.

``dbscan_cluster_means.iterations`` (label iterations run) and ``.syncs``
(host checks) count what the function did since they were last set to 0.
sklearn's ``dbscan_callback_means`` is not ported (ROADMAP.md §1,
assignment `callback` mode): the card machine has no sklearn.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# label iterations between two host checks of convergence. On an H100,
# over two calls and two inputs (a DTU step's endpoints, converged in 24
# iterations; seeded points, in 9), a check every 4 took the least mean
# host time, against 1, 2, 8 and 16 (PERF.md §6, the DTU path)
CHECK_EVERY = 4


def dbscan_cluster_means(
    points: torch.Tensor,
    point_mask: Optional[torch.Tensor] = None,
    eps: float = 0.01,
    min_samples: int = 2,
    max_prop_iters: int = 64,
    check_every: int = CHECK_EVERY,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cluster (N, 3) points; return (means (N, 3), valid (N,) bool).

    ``means[i]`` is the mean of the component whose lowest member index is
    ``i``, valid only there. Only points with at least ``min_samples``
    neighbours within ``eps`` (themselves included) are clustered."""
    n = points.shape[0]
    dev = points.device
    if point_mask is None:
        point_mask = torch.ones((n,), dtype=torch.bool, device=dev)

    # the squared distance summed x, y, z in that order, as jnp.sum does
    diff = points[:, None, :] - points[None, :, :]
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) + diff[..., 2] * diff[..., 2]
    adj = (d2 <= eps * eps) & point_mask[:, None] & point_mask[None, :]
    is_core = point_mask & (torch.sum(adj, dim=1) >= min_samples)
    core_adj = adj & is_core[:, None] & is_core[None, :]

    ids = torch.arange(n, device=dev)
    none = torch.full((), n, dtype=ids.dtype, device=dev)
    labels = torch.where(is_core, ids, none)
    it = 0
    while it < max_prop_iters:
        for _ in range(min(check_every, max_prop_iters - it)):
            prev = labels
            new = torch.minimum(labels, torch.min(torch.where(core_adj, labels[None, :], none), dim=1).values)
            # pointer jumping: convergence in O(log diameter) iterations
            new = torch.minimum(new, torch.where(new < n, labels[torch.clamp(new, max=n - 1)], none))
            labels = new
            it += 1
        dbscan_cluster_means.syncs += 1
        if not bool(torch.any(labels != prev)):
            break
    dbscan_cluster_means.iterations += it

    member = (labels[None, :] == ids[:, None]) & is_core[None, :]
    sums = torch.sum(torch.where(member[..., None], points[None, :, :], torch.zeros_like(points[:1, :1])), dim=1)
    counts = torch.sum(member, dim=1).to(points.dtype)
    means = sums / torch.clamp(counts, min=1.0)[:, None]
    valid = (counts >= 1.0) & (ids == labels) & is_core
    return means, valid


dbscan_cluster_means.iterations = 0
dbscan_cluster_means.syncs = 0
