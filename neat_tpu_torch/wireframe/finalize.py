"""Wireframe finalization: distill the trained fields into an explicit 3D
wireframe graph (port of neat_tpu/wireframe/finalize.py).

Parity target: reference code/neat-final-parsing.py (C21 in SURVEY.md):
  1. decode the global junctions and Newton-refine them onto the surface
     (x <- x - f(x) grad f(x), keep |sdf| < 0.05) (:173-187);
  2. per view, evaluate the attraction field on the support pixels
     (distance_threshold=1) in chunks, keep rendered 2D lines within
     ``line_dis_threshold`` px^2 of a detected HAWP line, group by the
     matched GT line and average the 3D segments (:190-260);
  3. vote endpoints onto global junctions via Hungarian matching within
     ``junc_match_threshold`` (:266-271); junctions with >= 2 votes
     survive (:293);
  4. keep per-view lines whose support-point distance score is below
     ``line_score_threshold`` (:279-281);
  5. snap both endpoints of every kept line to its nearest junction to
     form the junction-pair graph (:134-156);
  6. visibility-check the graph lines against every view's detections
     (:305-337);
  7. write {all, wfi, wfi_checked}.npz + the full result as a pickle of
     numpy arrays, keyed by a sha256 of the finalization hyperparameters
     (:383-426). The names and the pickles are the JAX package's, so each
     package reads the other's outputs.

The field is evaluated in fixed-size chunks of the eval-mode forward. On a
CUDA device those run the f32 K1 (the sampler's proposals) and the f32
K3-fwd (the field pass), ``model.neat.eval_kernel_config``; on the CPU the
plain versions. The graph assembly is numpy (host): it is tiny and runs
once.

    python -m neat_tpu_torch.wireframe.finalize --conf <rundir>/runconf.conf \\
        --checkpoint latest --data_root <dir> [--device cpu]
"""

from __future__ import annotations

import argparse
import base64
import hashlib
import os
import os.path as osp
import pickle
from collections import defaultdict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.camera import project2d
from ..fields.mlp import global_junctions_forward, implicit_sdf, implicit_sdf_feat_grad
from ..model.neat import NeatConfig, NeatModel, eval_kernel_config, neat_forward, offline_eval_config


def make_hash_sha256(obj) -> str:
    """Deterministic hyperparameter hash (reference neat-final-parsing.py:
    25-40). It hashes ``repr``, so pass Python floats and ints: numpy 2
    writes ``np.float32(10.0)`` where Python writes ``10.0``."""

    def make_hashable(o):
        if isinstance(o, (tuple, list)):
            return tuple(make_hashable(e) for e in o)
        if isinstance(o, dict):
            return tuple(sorted((k, make_hashable(v)) for k, v in o.items()))
        if isinstance(o, (set, frozenset)):
            return tuple(sorted(make_hashable(e) for e in o))
        return o

    hasher = hashlib.sha256()
    hasher.update(repr(make_hashable(obj)).encode())
    return base64.b64encode(hasher.digest()).decode()


def _device(model: NeatModel) -> torch.device:
    return next(model.parameters()).device


def _dtype(model: NeatModel) -> torch.dtype:
    return next(model.parameters()).dtype


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def model_sdf(model: NeatModel, cfg: NeatConfig, points: np.ndarray) -> np.ndarray:
    """The plain clamped SDF (N,) at host points, in the model's dtype."""
    with torch.no_grad():
        pts = torch.as_tensor(points, dtype=_dtype(model), device=_device(model))
        return _host(implicit_sdf(model.implicit, pts, cfg.implicit))[:, 0]


def project_to_view(scene, view: int, points3d: np.ndarray) -> np.ndarray:
    """``core.camera.project2d`` of host points (..., 3) into a view's image
    -> (..., 2), in the wider of the points' and the cameras' dtypes (as
    the JAX package promotes them)."""
    w2c = np.linalg.inv(scene.pose[view])
    dt = np.result_type(points3d, scene.intrinsics, w2c)
    as_t = lambda a: torch.as_tensor(np.asarray(a, dtype=dt))
    return _host(project2d(as_t(scene.intrinsics[view][:3, :3]), as_t(w2c[:3, :3]), as_t(w2c[:3, 3]), as_t(points3d)))


def newton_refine_junctions(
    model: NeatModel, cfg: NeatConfig, sdf_threshold: float = 0.05
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode global junctions, one Newton step onto the zero level set,
    sort by SIGNED sdf exactly as the reference does (:181
    ``argsort(glj_sdf)`` — most-negative/interior first, not by |sdf|;
    a stable sort, as ``jnp.argsort``). The gradient comes from autograd.
    Returns (junctions (J, 3), is_valid (J,) = |sdf| < threshold)."""
    with torch.no_grad():
        pts = global_junctions_forward(model.junctions, cfg.junctions)
        sdf, _, grad = implicit_sdf_feat_grad(model.implicit, pts, cfg.implicit)
        pts = pts - sdf * grad
        sdf2 = implicit_sdf(model.implicit, pts, cfg.implicit)[:, 0]
        order = torch.argsort(sdf2, stable=True)
        pts, sdf2 = pts[order], sdf2[order]
    return _host(pts), _host(torch.abs(sdf2) < sdf_threshold)


def view_field_lines(
    model: NeatModel,
    cfg: NeatConfig,
    scene,
    view: int,
    chunksize: int = 2048,
    mask_override: Optional[np.ndarray] = None,
    kernels: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Evaluate the attraction field on a view's support pixels.

    Returns (lines3d (N,2,3), lines2d (N,4), l3d (N,3), labels (N,)). Every
    chunk has ``chunksize`` rays: the last is edge-padded and its outputs
    trimmed, as in the JAX package. On a CUDA device the chunks run the
    f32 K1 and K3-fwd; ``kernels=False`` runs the plain versions there
    (what the kernels are held against)."""
    dev, dt = _device(model), _dtype(model)
    cfg = eval_kernel_config(cfg, dev) if kernels else offline_eval_config(cfg)
    mask = mask_override if mask_override is not None else scene.mask[view]
    pix = np.nonzero(mask)[0]
    labels = scene.labels[view][pix]
    h, w = scene.img_res
    uv = np.stack([pix % w, pix // w], axis=-1).astype(np.float32)
    uv_proj = scene.uv_proj[view][pix]

    as_t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    intr, pose = as_t(scene.intrinsics[view]), as_t(scene.pose[view])
    lines3d_all, lines2d_all, l3d_all = [], [], []
    for c0 in range(0, len(pix), chunksize):
        c1 = min(c0 + chunksize, len(pix))
        n = c1 - c0
        pad = chunksize - n
        inputs = {
            "uv": as_t(np.pad(uv[c0:c1], ((0, pad), (0, 0)), mode="edge")),
            "uv_proj": as_t(np.pad(uv_proj[c0:c1], ((0, pad), (0, 0)), mode="edge")),
            "intrinsics": intr,
            "pose": pose,
        }
        with torch.no_grad():
            out = neat_forward(model, inputs, cfg, training=False)
        lines3d_all.append(_host(out["lines3d"])[:n])
        lines2d_all.append(_host(out["lines2d"].reshape(-1, 4))[:n])
        l3d_all.append(_host(out["l3d"])[:n])
    if not lines3d_all:  # a view with an empty support mask
        return (
            np.zeros((0, 2, 3), np.float32),
            np.zeros((0, 4), np.float32),
            np.zeros((0, 3), np.float32),
            labels,
        )
    return (
        np.concatenate(lines3d_all),
        np.concatenate(lines2d_all),
        np.concatenate(l3d_all),
        labels,
    )


def wireframe_from_lines_and_junctions(
    lines: np.ndarray,
    junctions: np.ndarray,
    rel_matching_distance_threshold: float = 0.0,
    edge_vote_threshold: int = 1,
    drop_self_edges: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Snap line endpoints to nearest junctions -> adjacency + graph lines
    (reference :134-156). lines (L,2,3), junctions (J,3).

    ``edge_vote_threshold``: minimum number of distilled lines that must
    snap to a junction pair for the edge to survive (the reference admits
    an edge from a single line — the main source of spurious graph edges;
    1 = reference parity).
    ``drop_self_edges``: a line whose BOTH endpoints snap to the same
    junction is not an edge (default; a documented deviation) — the
    reference keeps graph[i,i]=1 and emits the zero-length (J,J) line in
    wfi, which downstream line metrics then count; False restores that."""
    ep1, ep2 = lines[:, 0], lines[:, 1]
    c1 = np.linalg.norm(ep1[:, None] - junctions[None], axis=-1)
    c2 = np.linalg.norm(ep2[:, None] - junctions[None], axis=-1)
    m1, i1 = c1.min(1), c1.argmin(1)
    m2, i2 = c2.min(1), c2.argmin(1)
    is_matched = np.maximum(m1, m2) < np.linalg.norm(ep1 - ep2, axis=-1)
    if rel_matching_distance_threshold > 0:
        is_matched &= np.maximum(m1, m2) < rel_matching_distance_threshold
    if drop_self_edges:
        is_matched &= i1 != i2

    counts = np.zeros((junctions.shape[0], junctions.shape[0]), dtype=np.int64)
    if is_matched.sum() > 0:
        lo = np.minimum(i1, i2)[is_matched]
        hi = np.maximum(i1, i2)[is_matched]
        np.add.at(counts, (lo, hi), 1)
    graph = (counts >= max(edge_vote_threshold, 1)).astype(np.float32)
    graph = np.maximum(graph, graph.T)
    iu, ju = np.nonzero(np.triu(graph))
    lines_wf = np.stack([junctions[iu], junctions[ju]], axis=1)
    return graph, lines_wf


def merge_voted_junctions(
    junctions: np.ndarray, votes: np.ndarray, eps: float,
    mode: str = "mean",
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy merge of near-duplicate voted junctions: process in
    descending-vote order; absorb all junctions within ``eps`` into the
    current one. Near-duplicates split the one-to-one Hungarian matching
    of the ABC eval, so they cost precision without adding recall.

    ``mode``: how the merged coordinate is formed. ``"mean"`` =
    vote-weighted mean of the group; ``"max"`` = the highest-voted
    member's coordinates unchanged (winner-takes-all): a duplicate is
    usually a latent that converged onto the same corner with worse
    localization, so the weighted mean contaminates the good twin."""
    if junctions.shape[0] == 0 or eps <= 0:
        return junctions, votes
    order = np.argsort(-votes)
    pts = junctions[order].astype(np.float64)
    vts = votes[order].astype(np.float64)
    used = np.zeros(len(pts), dtype=bool)
    out_pts, out_votes = [], []
    for i in range(len(pts)):
        if used[i]:
            continue
        d = np.linalg.norm(pts - pts[i], axis=-1)
        grp = (~used) & (d < eps)
        used |= grp
        w = vts[grp]
        if mode == "max":
            out_pts.append(pts[i])
        else:
            out_pts.append((pts[grp] * w[:, None]).sum(0) / w.sum())
        out_votes.append(w.sum())
    return (
        np.asarray(out_pts, dtype=np.float32),
        np.asarray(out_votes, dtype=np.int32),
    )


def initial_recon(
    model: NeatModel,
    cfg: NeatConfig,
    scene,
    chunksize: int = 2048,
    line_dis_threshold: float = 10.0,
    line_score_threshold: float = 0.01,
    junc_match_threshold: float = 0.05,
    sdf_junction_refine: bool = True,
    gt_line_threshold: float = 0.01,
    vote_threshold: int = 1,
    junction_merge_eps: float = 0.0,
    sdf_filter_threshold: float = 0.0,
    edge_vote_threshold: int = 1,
    verbose: bool = True,
) -> Dict[str, np.ndarray]:
    """Per-view field distillation + global-junction voting (reference
    :159-302): ``distill_views`` then ``assemble_wireframe``. The
    post-vote precision knobs default to reference parity (off)."""
    distilled = distill_views(
        model,
        cfg,
        scene,
        chunksize=chunksize,
        line_dis_threshold=line_dis_threshold,
        junc_match_threshold=junc_match_threshold,
        sdf_junction_refine=sdf_junction_refine,
        gt_line_threshold=gt_line_threshold,
        verbose=verbose,
    )
    return assemble_wireframe(
        distilled,
        model,
        cfg,
        line_score_threshold=line_score_threshold,
        vote_threshold=vote_threshold,
        junction_merge_eps=junction_merge_eps,
        sdf_filter_threshold=sdf_filter_threshold,
        edge_vote_threshold=edge_vote_threshold,
    )


def distill_views(
    model: NeatModel,
    cfg: NeatConfig,
    scene,
    chunksize: int = 2048,
    line_dis_threshold: float = 10.0,
    junc_match_threshold: float = 0.05,
    sdf_junction_refine: bool = True,
    gt_line_threshold: float = 0.01,
    verbose: bool = True,
) -> Dict[str, np.ndarray]:
    """The expensive half of finalization: per-view field evaluation,
    2D matching, per-detected-line averaging, and endpoint->junction
    voting (reference :159-271). The result is assembly-knob-free, so
    threshold sweeps (vote/merge/edge gates) reuse it."""
    from scipy.optimize import linear_sum_assignment

    if sdf_junction_refine:
        global_junctions, _ = newton_refine_junctions(model, cfg)
    else:
        with torch.no_grad():
            global_junctions = _host(global_junctions_forward(model.junctions, cfg.junctions))

    gjc_votes: Dict[int, list] = defaultdict(list)
    lines3d_all, scores_all = [], []

    for view in range(scene.n_images):
        lines3d, lines2d, l3d, _ = view_field_lines(model, cfg, scene, view, chunksize)
        # duplicate with swapped endpoint order (reference :229-234)
        lines3d = np.concatenate([lines3d, lines3d[:, [1, 0]]], axis=0)
        lines2d = np.concatenate([lines2d, lines2d[:, [2, 3, 0, 1]]], axis=0)
        points3d = np.concatenate([l3d, l3d], axis=0)

        # match against the wide 0.01-threshold detection set (reference
        # neat-final-parsing.py:235), not the 0.05 training set
        if scene.lines_lo is not None:
            nl = scene.n_lines_lo[view]
            gt5 = scene.lines_lo[view][:nl]
        else:
            nl = scene.n_lines[view]
            gt5 = scene.lines[view][:nl]
        gt_lines = gt5[gt5[:, 4] > gt_line_threshold][:, :4]
        if gt_lines.shape[0] == 0:
            continue

        dis = ((lines2d[:, None] - gt_lines[None]) ** 2).sum(-1)
        mindis = dis.min(1)
        minidx = dis.argmin(1)
        keep = mindis < line_dis_threshold
        if keep.sum() == 0:
            continue
        assignment = minidx[keep]
        lines3d_valid = lines3d[keep]
        points3d_valid = points3d[keep]

        view_lines, view_scores = [], []
        for label in np.unique(assignment):
            idx = np.nonzero(assignment == label)[0]
            val = lines3d_valid[idx].mean(axis=0)  # (2, 3)
            support = points3d_valid[idx]
            denom = max(np.linalg.norm(val[1] - val[0]), 1e-6)
            support_dis = (
                np.linalg.norm(np.cross(support - val[0], support - val[1]), axis=-1)
                / denom
            )
            view_lines.append(val)
            view_scores.append(support_dis.mean())

        view_lines = np.stack(view_lines)
        view_scores = np.asarray(view_scores, dtype=np.float32)

        endpoints = view_lines.reshape(-1, 3)
        cdist = np.linalg.norm(global_junctions[:, None] - endpoints[None], axis=-1)
        ai, aj = linear_sum_assignment(cdist)
        for a, b in zip(ai, aj):
            if cdist[a, b] < junc_match_threshold:
                gjc_votes[int(a)].append(endpoints[b])

        lines3d_all.append(view_lines)
        scores_all.append(view_scores)
        if verbose:
            print(
                f"view {view}: junctions voted {len(gjc_votes)} <-- "
                f"{sum(l.shape[0] for l in lines3d_all)} lines"
            )

    # an underfit checkpoint can produce zero matched lines in every view;
    # return empty results instead of crashing after the full sweep
    if lines3d_all:
        lines3d_all = np.concatenate(lines3d_all, axis=0)
    else:
        lines3d_all = np.zeros((0, 2, 3), dtype=np.float32)
    scores_all = (
        np.concatenate(scores_all, axis=0) if scores_all else np.zeros((0,), dtype=np.float32)
    )
    votes_idx = np.asarray([k for k, v in gjc_votes.items() for _ in v], dtype=np.int32)
    votes_pts = (
        np.asarray([p for v in gjc_votes.values() for p in v], dtype=np.float32)
        if votes_idx.size
        else np.zeros((0, 3), dtype=np.float32)
    )
    return {
        "global_junctions": global_junctions,
        "lines3d_raw": lines3d_all,
        "scores_raw": scores_all,
        "votes_idx": votes_idx,
        "votes_pts": votes_pts,
    }


def effective_vote_threshold(vote_threshold: int, vote_ratio: float, n_views: int) -> int:
    """View-count-relative vote gate. True junctions collect endpoint
    votes from a large fraction of the views they are visible in, while
    the voting stage's structural false positives collect only a handful,
    so a threshold proportional to the view count separates the
    populations across scenes. ``vote_ratio`` 0 disables (reference
    parity); the result never drops below the absolute ``vote_threshold``."""
    if vote_ratio <= 0.0:
        return vote_threshold
    return max(vote_threshold, int(round(vote_ratio * n_views)))


def effective_check_views(ckview: int, check_view_ratio: float, n_views: int) -> int:
    """View-count-relative visibility-check gate. The reference's
    ``--ckview`` default of 5 is calibrated for DTU scan24's 49 views
    (neat-final-parsing.py:415, 440), about 10% of the views; as a ratio,
    0.1 x 49 -> 5 reproduces it and scales to smaller captures.
    ``check_view_ratio`` 0 disables (reference parity: the absolute
    ``ckview`` is used)."""
    if check_view_ratio <= 0.0:
        return ckview
    return max(1, int(round(check_view_ratio * n_views)))


# the measured-best assembly knobs of the JAX package's sweeps
# (docs/geometry_sweep_r4.md): applied by the CLI's --recipe calibrated
# for any knob the user left at its reference-parity default
CALIBRATED_RECIPE = {
    "vote_ratio": 0.2,
    "junction_merge_eps": 0.02,
    "merge_before_vote": True,
    "junction_coords": "vote_mean",
    "check_view_ratio": 0.1,
}


def assemble_wireframe(
    distilled: Dict[str, np.ndarray],
    model: NeatModel,
    cfg: NeatConfig,
    line_score_threshold: float = 0.01,
    vote_threshold: int = 1,
    junction_merge_eps: float = 0.0,
    sdf_filter_threshold: float = 0.0,
    edge_vote_threshold: int = 1,
    merge_before_vote: bool = False,
    merge_mode: str = "mean",
    junction_coords: str = "latent",
) -> Dict[str, np.ndarray]:
    """The cheap half of finalization: score gate, vote gate, optional
    precision post-processing, graph assembly (reference :272-302).

    ``merge_before_vote``: apply ``junction_merge_eps`` to the full
    voted-any junction set BEFORE the vote gate, summing votes across a
    merged group (two latents on one corner split its votes).

    ``junction_coords``: where a kept junction's 3D coordinate comes
    from. ``"latent"`` = the ffn(latent) output (Newton-refined; the
    reference's choice, :173-187). ``"vote_mean"`` / ``"vote_median"`` =
    the mean/median of the junction's voting endpoints."""
    global_junctions = distilled["global_junctions"]
    lines3d_all = distilled["lines3d_raw"][distilled["scores_raw"] < line_score_threshold]
    gjc_votes: Dict[int, list] = defaultdict(list)
    for k, p in zip(distilled["votes_idx"], distilled["votes_pts"]):
        gjc_votes[int(k)].append(p)

    def _coord(k: int) -> np.ndarray:
        if junction_coords == "latent":
            return global_junctions[k]
        v = np.asarray(gjc_votes[k], dtype=np.float64)
        return v.mean(0) if junction_coords == "vote_mean" else np.median(v, 0)

    def _points(keys) -> np.ndarray:
        if not len(keys):
            return np.zeros((0, 3), dtype=np.float32)
        return np.asarray([_coord(k) for k in keys], dtype=np.float32)

    if junction_merge_eps > 0 and merge_before_vote:
        keys = sorted(gjc_votes.keys())
        pts = _points(keys)
        counts = np.asarray([len(gjc_votes[k]) for k in keys], dtype=np.int32)
        pts, counts = merge_voted_junctions(pts, counts, junction_merge_eps, mode=merge_mode)
        keep = counts > vote_threshold
        junctions3d_initial = pts[keep]
        vote_counts = counts[keep]
    else:
        voted = [k for k, v in gjc_votes.items() if len(v) > vote_threshold]
        junctions3d_initial = _points(voted)
        vote_counts = np.asarray([len(gjc_votes[k]) for k in voted], dtype=np.int32)

    if sdf_filter_threshold > 0 and junctions3d_initial.shape[0] > 0:
        keep = np.abs(model_sdf(model, cfg, junctions3d_initial)) < sdf_filter_threshold
        junctions3d_initial = junctions3d_initial[keep]
        vote_counts = vote_counts[keep]
    if junction_merge_eps > 0 and not merge_before_vote:
        junctions3d_initial, vote_counts = merge_voted_junctions(
            junctions3d_initial, vote_counts, junction_merge_eps, mode=merge_mode,
        )

    if junctions3d_initial.shape[0] > 0:
        # zero surviving lines still yields the (J, J) zero adjacency
        # aligned with junctions3d_initial
        graph_initial, lines3d_wfi = wireframe_from_lines_and_junctions(
            lines3d_all,
            junctions3d_initial,
            rel_matching_distance_threshold=0,
            edge_vote_threshold=edge_vote_threshold,
        )
    else:
        graph_initial = np.zeros((0, 0), dtype=np.float32)
        lines3d_wfi = np.zeros((0, 2, 3), dtype=np.float32)

    return {
        "junctions3d_initial": junctions3d_initial,
        "lines3d_all": lines3d_all,
        "graph_initial": graph_initial,
        "lines3d_wfi": lines3d_wfi,
        "global_junctions": global_junctions,
        "junction_votes": vote_counts,
    }


def visibility_checking(
    lines3d: np.ndarray,
    scene,
    mindis_th: float = 25.0,
    min_visible_views: int = 1,
    gt_line_threshold: float = 0.05,
) -> np.ndarray:
    """Keep lines whose 2D projection is near a detected line in enough
    views (reference :305-337)."""
    if lines3d.shape[0] == 0:
        return lines3d
    visibility = np.zeros((lines3d.shape[0], scene.n_images), dtype=bool)
    for view in range(scene.n_images):
        nl = scene.n_lines[view]
        gt5 = scene.lines[view][:nl]
        gt = gt5[gt5[:, 4] > gt_line_threshold][:, :4]
        if gt.shape[0] == 0:
            continue
        l2d = project_to_view(scene, view, lines3d).reshape(-1, 4)
        d1 = ((l2d[:, None] - gt[None]) ** 2).sum(-1)
        d2 = ((l2d[:, None] - gt[None][:, :, [2, 3, 0, 1]]) ** 2).sum(-1)
        mindis = np.minimum(d1, d2).min(1)
        visibility[mindis < mindis_th, view] = True
    return lines3d[visibility.sum(axis=1) >= min_visible_views]


def wireframe_recon(
    conf: str,
    checkpoint: str = "latest",
    chunksize: int = 2048,
    distance: float = 10.0,
    ckdist: float = 100.0,
    ckview: int = 5,
    junc_match_threshold: float = 0.02,
    check_view_ratio: float = 0.0,
    vote_threshold: int = 1,
    vote_ratio: float = 0.0,
    junction_merge_eps: float = 0.0,
    merge_before_vote: bool = False,
    merge_mode: str = "mean",
    junction_coords: str = "latent",
    sdf_filter_threshold: float = 0.0,
    edge_vote_threshold: int = 1,
    sdf_junction_refine: bool = True,
    overwrite: bool = False,
    data_root: str = "../data",
    assignment_method: str = "auction",
    verbose: bool = True,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Full finalization entry (reference wireframe_recon, :339-427).

    ``conf`` must be the runconf.conf inside a training timestamp dir.
    Writes {ckpt}-{sha8}-{all,wfi,wfi_checked}.npz + {ckpt}-{sha8}-neat.pkl
    (and the per-view distillation cache {ckpt}-{sha8}-distill.pkl) under
    <rundir>/wireframes/, named and laid out as the JAX package's.
    """
    from ..data.datasets import load_scene_for_config
    from ..train.checkpoint import load_model
    from ..train.config import load_experiment_config

    assert osp.basename(conf) == "runconf.conf", "pass a rundir runconf.conf"
    rundir = osp.dirname(conf)

    cfg = load_experiment_config(conf, assignment_method=assignment_method)
    model, epoch = load_model(osp.join(rundir, "checkpoints"), checkpoint, cfg.model, device)

    # rebuild the dataset at distance_threshold = 1 (reference :349-372)
    scene = load_scene_for_config(cfg, data_root, distance_threshold=1.0)

    wireframe_dir = osp.join(rundir, "wireframes")
    os.makedirs(wireframe_dir, exist_ok=True)

    # two-level caching: the expensive per-view distillation is keyed by
    # its own knobs only, so assembly-threshold sweeps reuse it; the
    # assembled outputs carry the full-knob hash. The conf key is
    # realpath'ed so a symlinked rundir hits the same cache.
    conf_key = osp.realpath(conf)
    # canonical numeric types: the hash is of repr(), so an int 10 from an
    # argparse default must key as the API's float 10.0
    distance = float(distance)
    ckdist = float(ckdist)
    junc_match_threshold = float(junc_match_threshold)
    junction_merge_eps = float(junction_merge_eps)
    sdf_filter_threshold = float(sdf_filter_threshold)
    vote_threshold = int(vote_threshold)
    edge_vote_threshold = int(edge_vote_threshold)
    ckview = int(ckview)
    distill_sha = make_hash_sha256(
        {
            "conf": conf_key,
            "checkpoint": checkpoint,
            # the RESOLVED epoch: 'latest' changes meaning as training goes on
            "epoch": int(epoch),
            # keyed to the data it matched against
            "data_root": osp.realpath(data_root),
            "distance": distance,
            "junc_match_threshold": junc_match_threshold,
            "sdf_junction_refine": sdf_junction_refine,
        }
    )[:8].replace("/", "n")
    distill_path = osp.join(wireframe_dir, f"{checkpoint}-{distill_sha}-distill.pkl")
    if osp.exists(distill_path) and not overwrite:
        with open(distill_path, "rb") as f:
            distilled = pickle.load(f)
    else:
        distilled = distill_views(
            model,
            cfg.model,
            scene,
            chunksize=chunksize,
            line_dis_threshold=distance,
            junc_match_threshold=junc_match_threshold,
            sdf_junction_refine=sdf_junction_refine,
            verbose=verbose,
        )
        with open(distill_path, "wb") as f:
            pickle.dump(distilled, f)

    if vote_ratio > 0.0:
        vote_threshold = effective_vote_threshold(vote_threshold, vote_ratio, int(scene.n_images))
        if verbose:
            print(f"vote_ratio {vote_ratio} x {scene.n_images} views -> effective vote_threshold {vote_threshold}")

    if check_view_ratio > 0.0:
        # resolved BEFORE the output hash: the effective integer folds into
        # the "ckview" key, so ratio-addressed outputs share names with
        # their equivalent absolute-ckview runs
        ckview = effective_check_views(ckview, check_view_ratio, int(scene.n_images))
        if verbose:
            print(f"check_view_ratio {check_view_ratio} x {scene.n_images} views -> effective ckview {ckview}")

    sha256 = make_hash_sha256(
        {
            "conf": conf_key,
            "checkpoint": checkpoint,
            "distance": distance,
            "junc_match_threshold": junc_match_threshold,
            "sdf_junction_refine": sdf_junction_refine,
            "data_root": osp.realpath(data_root),
            "vote_threshold": vote_threshold,
            "junction_merge_eps": junction_merge_eps,
            # only non-default merge variants change the key
            **({"merge_before_vote": True} if merge_before_vote else {}),
            **({"merge_mode": merge_mode} if merge_mode != "mean" else {}),
            **({"junction_coords": junction_coords} if junction_coords != "latent" else {}),
            "sdf_filter_threshold": sdf_filter_threshold,
            "edge_vote_threshold": edge_vote_threshold,
            "ckdist": ckdist,
            "ckview": ckview,
        }
    )[:8].replace("/", "n")
    out_base = f"{checkpoint}-{sha256}"
    pth_path = osp.join(wireframe_dir, f"{out_base}-neat.pkl")

    results = assemble_wireframe(
        distilled,
        model,
        cfg.model,
        vote_threshold=vote_threshold,
        junction_merge_eps=junction_merge_eps,
        sdf_filter_threshold=sdf_filter_threshold,
        edge_vote_threshold=edge_vote_threshold,
        merge_before_vote=merge_before_vote,
        merge_mode=merge_mode,
        junction_coords=junction_coords,
    )
    results["kwargs"] = {
        "conf": conf,
        "checkpoint": checkpoint,
        "distance": distance,
        "ckdist": ckdist,
        "ckview": ckview,
        "check_view_ratio": check_view_ratio,
        "junc_match_threshold": junc_match_threshold,
        "vote_threshold": vote_threshold,
        "vote_ratio": vote_ratio,
        "junction_merge_eps": junction_merge_eps,
        "merge_before_vote": merge_before_vote,
        "merge_mode": merge_mode,
        "junction_coords": junction_coords,
        "sdf_filter_threshold": sdf_filter_threshold,
        "edge_vote_threshold": edge_vote_threshold,
        "epoch": epoch,
    }

    results["lines3d_wfi_checked"] = visibility_checking(
        results["lines3d_wfi"], scene, mindis_th=ckdist, min_visible_views=ckview
    )

    for key in ("all", "wfi", "wfi_checked"):
        np.savez(osp.join(wireframe_dir, f"{out_base}-{key}.npz"), lines3d=results[f"lines3d_{key}"])
    with open(pth_path, "wb") as f:
        pickle.dump(results, f)
    if verbose:
        print(
            f"finalized: {results['lines3d_all'].shape[0]} lines, "
            f"{results['junctions3d_initial'].shape[0]} junctions, "
            f"{results['lines3d_wfi'].shape[0]} wfi, "
            f"{results['lines3d_wfi_checked'].shape[0]} wfi_checked -> "
            f"{wireframe_dir}/{out_base}-*.npz"
        )
    return results


def unported_mesh(flag: str) -> NotImplementedError:
    return NotImplementedError(f"{flag} (a data-parallel mesh) is not ported yet (ROADMAP.md §1, multi-GPU)")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="neat_tpu_torch wireframe finalization (reference neat-final-parsing.py CLI)"
    )
    parser.add_argument("--conf", type=str, required=True)
    parser.add_argument("--checkpoint", default="latest", type=str)
    parser.add_argument("--chunksize", default=2048, type=int)
    parser.add_argument("--reproj-dis", default=10.0, type=float, dest="reproj_dis")
    parser.add_argument("--ckdist", default=100.0, type=float)
    parser.add_argument("--ckview", default=5, type=int)
    parser.add_argument("--check-view-ratio", default=0.0, type=float, dest="check_view_ratio",
                        help="visibility-check gate as a fraction of the view count "
                        "(0 = reference parity, the absolute --ckview applies)")
    parser.add_argument("--recipe", default="reference", choices=["reference", "calibrated"],
                        help="assembly preset: 'reference' keeps the reference CLI defaults; "
                        "'calibrated' applies CALIBRATED_RECIPE to every knob left at its "
                        "default; explicit flags win over the preset")
    parser.add_argument("--overwrite", default=False, action="store_true")
    parser.add_argument("--disable-junction-refine", default=False, action="store_true")
    parser.add_argument("--junc_match_threshold", default=0.02, type=float)
    parser.add_argument("--vote-threshold", default=1, type=int, dest="vote_threshold",
                        help="keep junctions with more than this many votes")
    parser.add_argument("--vote-ratio", default=0.0, type=float, dest="vote_ratio",
                        help="vote threshold as a fraction of the view count (0 = reference parity)")
    parser.add_argument("--junction-merge-eps", default=0.0, type=float, dest="junction_merge_eps",
                        help="vote-weighted merge radius for near-duplicate voted junctions")
    parser.add_argument("--merge-before-vote", default=False, action="store_true", dest="merge_before_vote",
                        help="merge duplicate junctions BEFORE the vote gate")
    parser.add_argument("--merge-mode", default="mean", choices=["mean", "max"], dest="merge_mode",
                        help="merged-coordinate rule: vote-weighted mean vs winner-takes-all")
    parser.add_argument("--junction-coords", default="latent", choices=["latent", "vote_mean", "vote_median"],
                        dest="junction_coords",
                        help="junction coordinate source: the ffn(latent) output or the "
                        "mean/median of the junction's voting endpoints")
    parser.add_argument("--sdf-filter", default=0.0, type=float, dest="sdf_filter_threshold",
                        help="drop voted junctions with |sdf| above this (0 = reference parity)")
    parser.add_argument("--edge-vote-threshold", default=1, type=int, dest="edge_vote_threshold",
                        help="min distilled-line support for a graph edge (1 = reference parity)")
    parser.add_argument("--data_root", default="../data", type=str)
    parser.add_argument("--mesh", default=0, type=int, dest="mesh_devices",
                        help="shard the distillation over an N-device mesh (not ported: raises)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.mesh_devices:
        raise unported_mesh("--mesh")

    if args.recipe == "calibrated":
        for knob, value in CALIBRATED_RECIPE.items():
            if getattr(args, knob) == parser.get_default(knob):
                setattr(args, knob, value)

    return wireframe_recon(
        conf=args.conf,
        checkpoint=args.checkpoint,
        chunksize=args.chunksize,
        distance=args.reproj_dis,
        ckdist=args.ckdist,
        ckview=args.ckview,
        check_view_ratio=args.check_view_ratio,
        overwrite=args.overwrite,
        sdf_junction_refine=not args.disable_junction_refine,
        junc_match_threshold=args.junc_match_threshold,
        vote_threshold=args.vote_threshold,
        vote_ratio=args.vote_ratio,
        junction_merge_eps=args.junction_merge_eps,
        merge_before_vote=args.merge_before_vote,
        merge_mode=args.merge_mode,
        junction_coords=args.junction_coords,
        sdf_filter_threshold=args.sdf_filter_threshold,
        edge_vote_threshold=args.edge_vote_threshold,
        data_root=args.data_root,
        device=args.device,
    )


if __name__ == "__main__":
    main()
