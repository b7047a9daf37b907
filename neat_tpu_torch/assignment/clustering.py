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

``dbscan_callback_means`` is the JAX package's sklearn DBSCAN through a
host callback, for any ``min_samples``. The card machine has no sklearn,
so it runs sklearn's algorithm on the host in numpy and scipy: the eps
neighbourhoods (themselves included) from ``scipy.spatial.cKDTree``, and
sklearn's expansion, which grows one cluster at a time from the core
points in index order, so that a border point that two clusters reach
takes the first one's label. No model path calls it, in either package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
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


def _sklearn_dbscan_labels(points: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """sklearn.cluster.DBSCAN(eps, min_samples).fit(points).labels_: the
    cluster of each point, -1 for noise."""
    from scipy.spatial import cKDTree

    neighbourhoods = cKDTree(points).query_ball_point(points, r=eps)
    is_core = np.asarray([len(nb) >= min_samples for nb in neighbourhoods], dtype=bool)
    labels = np.full(points.shape[0], -1, dtype=np.intp)
    label = 0
    for start in range(points.shape[0]):
        if labels[start] != -1 or not is_core[start]:
            continue
        # sklearn's dbscan_inner: a depth-first expansion that ends at the
        # non-core points
        stack, i = [], start
        while True:
            if labels[i] == -1:
                labels[i] = label
                if is_core[i]:
                    stack.extend(v for v in neighbourhoods[i] if labels[v] == -1)
            if not stack:
                break
            i = stack.pop()
        label += 1
    return labels


def dbscan_callback_means(
    points: torch.Tensor, point_mask: torch.Tensor, eps: float = 0.01, min_samples: int = 2
) -> Tuple[torch.Tensor, torch.Tensor]:
    """sklearn's DBSCAN of the masked points on the host (a sync), padded
    as ``dbscan_cluster_means``: ``means[i]`` is the mean of the cluster
    whose first member index is ``i``, valid only there. Returns (means
    (N, 3) in the points' dtype, valid (N,) bool) on the points' device."""
    pts = points.detach().cpu().numpy()
    mask = point_mask.detach().cpu().numpy().astype(bool)
    means = np.zeros_like(pts)
    valid = np.zeros(pts.shape[0], dtype=bool)
    idx = np.nonzero(mask)[0]
    if len(idx) >= min_samples:
        labels = _sklearn_dbscan_labels(pts[idx], eps, min_samples)
        for lab in range(labels.max() + 1):
            members = idx[labels == lab]
            rep = members.min()
            means[rep] = pts[members].mean(axis=0)
            valid[rep] = True
    return torch.from_numpy(means).to(points.device), torch.from_numpy(valid).to(points.device)
