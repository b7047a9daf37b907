"""The port's host-side assignment and clustering against neat_tpu's
callbacks.

``masked_assignment(method='callback')`` (scipy's Hungarian over the
masked submatrix, padded back out) against JAX's ``hungarian_callback``
on seeded costs with masked rows and columns: column, valid flag and
dtype exactly. ``dbscan_callback_means`` (sklearn's DBSCAN written in
numpy and scipy) against JAX's, which runs sklearn: the valid rows
exactly, the means within 1e-12 in f64 (the same numpy mean of the same
members gives the same bits), on clouds where border points lie within
eps of the core points of two clusters, so that the order of expansion
decides them; and its labels against sklearn's own.

The callback mode draws nothing: a training step with it leaves the
step's generator where a step with the auction leaves it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.cluster import DBSCAN

import neat_tpu.assignment.clustering as jclust
import neat_tpu.assignment.matching as jmatch
import neat_tpu_torch.assignment.clustering as tclust
import neat_tpu_torch.assignment.matching as tmatch
import neat_tpu_torch.model.loss as tloss
import neat_tpu_torch.train.step as tstep
from _torch_helpers import configs, small_scene, t
from neat_tpu_torch.model.neat import init_neat

EPS = 0.01


def _cost_and_masks(seed, rows, cols, mask):
    rs = np.random.RandomState(seed)
    cost = rs.uniform(0.0, 10.0, (rows, cols))
    cost[rs.rand(rows, cols) < 0.2] = 5.0  # ties
    row_mask = np.ones(rows, bool)
    col_mask = np.ones(cols, bool)
    if mask in ("rows", "both"):
        row_mask = rs.rand(rows) < 0.7
    if mask in ("cols", "both"):
        col_mask = rs.rand(cols) < 0.6
    if mask == "none_live":
        row_mask[:] = False
    return cost, row_mask, col_mask


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mask", ["none", "rows", "cols", "both", "none_live"])
@pytest.mark.parametrize("rows,cols", [(8, 8), (12, 30), (30, 12)])
def test_callback_assignment_equals_jax(rows, cols, mask, dtype):
    cost, row_mask, col_mask = _cost_and_masks(rows * 100 + cols, rows, cols, mask)
    cost = cost.astype(dtype)
    with jax.enable_x64(True):  # JAX keeps the f64 cost f64
        ref_col, ref_valid = (np.asarray(a) for a in jmatch.masked_assignment(
            jnp.asarray(cost), jnp.asarray(row_mask), jnp.asarray(col_mask), method="callback"))
    col, valid = tmatch.masked_assignment(t(cost), t(row_mask), t(col_mask), method="callback")
    assert col.dtype == torch.int32 and valid.dtype == torch.bool
    assert col.device == valid.device == torch.device("cpu")
    assert np.array_equal(col.numpy(), ref_col) and np.array_equal(valid.numpy(), ref_valid)
    assert int(valid.sum()) == (min(row_mask.sum(), col_mask.sum()) if mask != "none_live" else 0)


def test_callback_assignment_counts_its_syncs():
    tmatch.hungarian_callback.syncs, tmatch.hungarian_callback.host_s = 0, 0.0
    cost = torch.rand(5, 7, generator=torch.Generator().manual_seed(0))
    tmatch.masked_assignment(cost, method="callback")
    tmatch.masked_assignment(cost, torch.zeros(5, dtype=torch.bool), method="callback")
    assert tmatch.hungarian_callback.syncs == 2 and tmatch.hungarian_callback.host_s > 0
    with pytest.raises(ValueError, match="unknown assignment method"):
        tmatch.masked_assignment(cost, method="hungarian")


def _two_clusters_sharing_borders(seed):
    """Six pairs of clusters and noise, in a random order. A cluster is a
    clump of 3-5 points within 0.0005 of a centre and an edge point 0.004
    from it; the pair's edges are 0.014 apart and a border point sits
    between them, 0.007 from each edge and 0.011 from each clump. With
    min_samples 4 the border point is not core and both clusters reach it;
    with 2 or 3 it is core and joins the pair into one cluster. No pair of
    points lies within 1e-4 of eps."""
    rs = np.random.RandomState(seed)
    x = np.asarray([1.0, 0.0, 0.0])
    pts = []
    for c in rs.uniform(-1.0, 1.0, (6, 3)):
        for centre, edge in ((c, c + 0.004 * x), (c + 0.022 * x, c + 0.018 * x)):
            pts.append(centre + rs.uniform(-0.0005, 0.0005, (rs.randint(3, 6), 3)) / np.sqrt(3))
            pts.append(edge[None] + rs.uniform(-0.0001, 0.0001, (1, 3)))
        pts.append((c + 0.011 * x)[None] + rs.uniform(-0.0001, 0.0001, (1, 3)))
    pts.append(rs.uniform(-2.0, 2.0, (40, 3)))
    pts = np.concatenate(pts)
    pts = pts[rs.permutation(len(pts))]
    d = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1))
    assert not ((d > 0) & (np.abs(d - EPS) < 1e-4)).any()
    return pts


@pytest.mark.parametrize("min_samples", [2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_dbscan_labels_equal_sklearn(seed, min_samples):
    pts = _two_clusters_sharing_borders(seed)
    ref = DBSCAN(eps=EPS, min_samples=min_samples).fit(pts).labels_
    got = tclust._sklearn_dbscan_labels(pts, EPS, min_samples)
    assert np.array_equal(got, ref)
    assert ref.max() + 1 == (12 if min_samples == 4 else 6)
    assert (ref >= 0).sum() == len(pts) - 40  # every point of a pair is in a cluster


@pytest.mark.parametrize("mask", ["all", "some", "none", "one"])
@pytest.mark.parametrize("min_samples", [2, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dbscan_callback_means_equal_jax(dtype, min_samples, mask):
    pts = _two_clusters_sharing_borders(3).astype(dtype)
    rs = np.random.RandomState(4)
    point_mask = {"all": np.ones(len(pts), bool), "some": rs.rand(len(pts)) < 0.8,
                  "none": np.zeros(len(pts), bool), "one": np.arange(len(pts)) == 5}[mask]
    with jax.enable_x64(True):  # JAX keeps the f64 points f64
        ref_m, ref_v = (np.asarray(a) for a in jclust.dbscan_callback_means(
            jnp.asarray(pts), jnp.asarray(point_mask), eps=EPS, min_samples=min_samples))
    assert ref_m.dtype == dtype
    m, v = tclust.dbscan_callback_means(t(pts), t(point_mask), eps=EPS, min_samples=min_samples)
    assert m.dtype == t(pts).dtype and v.dtype == torch.bool and m.shape == pts.shape
    assert np.array_equal(v.numpy(), ref_v)
    np.testing.assert_allclose(m.numpy(), ref_m, rtol=0, atol=1e-12)
    assert v.any() == (mask in ("all", "some"))


def test_callback_step_draws_what_the_auction_step_draws():
    """neither assignment draws: after one step from the same generator,
    both leave it in the same state"""
    cfg_t = configs()[1]
    scene = {k: t(v) for k, v in small_scene(configs()[0]).items()}
    states = {}
    for method in ("auction", "callback"):
        cfg = dataclasses.replace(cfg_t, assignment_method=method)
        step = tstep.make_train_step(cfg, tloss.LossConfig(assignment_method=method), 5e-4, 0.1, 1000, 12, 32)
        gen = torch.Generator().manual_seed(5)
        state = tstep.init_train_state(init_neat(cfg, seed=0, device="cpu"))
        state, metrics = step(state, scene, gen)
        assert np.isfinite(float(metrics["loss"]))
        states[method] = gen.get_state()
    assert torch.equal(states["auction"], states["callback"])
