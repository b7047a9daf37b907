"""Alternative wireframe distillation tools (port of
neat_tpu/wireframe/distill.py). The field evaluations go through
``finalize.view_field_lines`` (the f32 K1 and K3-fwd on the card) and the
plain SDF; the rest is numpy, as in the JAX package.

    python -m neat_tpu_torch.wireframe.distill {simple,merge,nms,fuse,refine,dgrid} ...

Parity targets (reference code/evaluation/, SURVEY.md §2 C26):
  * wireframe.py:18-237  — ``simple_recon``: per-view, per-GT-line mean of
    the 2D-gated attraction lines, no junction snapping;
  * wireframe-merge.py:195-209 — ``merge_wireframes``: sequential set
    accumulation where an existing line suppresses only its nearest
    incoming line within 0.05x its own length;
  * nms.py:162-203       — ``nms_lines``: grid junction snapping — bin
    endpoints into a 512^3 grid over their bbox, find count local maxima
    (3^3 max-pool), snap every line's endpoints to the nearest maxima;
  * fusion.py:79-134     — ``fuse_lines``: cross-view detection-score
    fusion (+ the reference's enumeration-index scoring quirk as a flag);
  * refinement.py:95-181 — ``refinement_recon``: sdf/score pre-filter then
    per-view re-matching with matched-group averaging;
  * dgrid.py:120-279     — ``dgrid_recon``: scene-grid surface points,
    per-view attraction evaluation at their projections, cross-view
    label-signature clustering (the reference script is unfinished — it
    hits a pdb + undefined variable after building ``lines_nms``; parity
    is through that stage);
  * ``refine_lines_sdf`` — an extra, non-reference convenience: Newton-
    project endpoints onto the SDF zero set (the finalization's junction
    refinement applied to lines).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from .finalize import model_sdf, project_to_view, view_field_lines


def simple_recon(
    model,
    cfg,
    scene,
    chunksize: int = 2048,
    dis_threshold: float = 10.0,
    verbose: bool = False,
) -> np.ndarray:
    """Per-label mean distillation without junctions (reference
    evaluation/wireframe.py). Returns (L, 2, 3) lines."""
    lines3d_all = []
    for view in range(scene.n_images):
        lines3d, lines2d, _, labels = view_field_lines(
            model, cfg, scene, view, chunksize
        )
        nl = scene.n_lines[view]
        gt = scene.lines[view][:nl][:, :4]
        gt_per_pix = gt[labels]
        d1 = ((lines2d - gt_per_pix) ** 2).sum(-1)
        d2 = ((lines2d - gt_per_pix[:, [2, 3, 0, 1]]) ** 2).sum(-1)
        is_correct = np.minimum(d1, d2) < dis_threshold

        by_label: Dict[int, List[np.ndarray]] = defaultdict(list)
        for lab in np.unique(labels[is_correct]):
            sel = is_correct & (labels == lab)
            by_label[int(lab)].append(lines3d[sel])
        view_lines = [
            np.concatenate(v).mean(axis=0) for v in by_label.values() if len(v)
        ]
        if view_lines:
            lines3d_all.append(np.stack(view_lines))
        if verbose:
            print(f"view {view}: {len(view_lines)} lines")
    if not lines3d_all:
        return np.zeros((0, 2, 3), dtype=np.float32)
    return np.concatenate(lines3d_all, axis=0)


def line_pair_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(A, 2, 3) x (B, 2, 3) -> (A, B) endpoint-order-min mean distance."""
    d1 = np.linalg.norm(a[:, None] - b[None], axis=-1).mean(-1)
    d2 = np.linalg.norm(a[:, None] - b[None, :, [1, 0]], axis=-1).mean(-1)
    return np.minimum(d1, d2)


def greedy_suppress_lines(
    lines: np.ndarray,
    scores: Optional[np.ndarray] = None,
    threshold: float = 0.01,
) -> np.ndarray:
    """Greedy suppression of near-duplicate 3D segments (keep the
    best-scoring line of every group). NOT a reference tool — kept as the
    duplicate-collapse helper for grid_distill."""
    if lines.shape[0] == 0:
        return lines
    scores = scores if scores is not None else np.zeros(lines.shape[0])
    order = np.argsort(scores)  # lower score (distance) = better
    lines_sorted = lines[order]
    dist = line_pair_distance(lines_sorted, lines_sorted)
    keep = np.ones(len(lines_sorted), dtype=bool)
    for i in range(len(lines_sorted)):
        if not keep[i]:
            continue
        dup = dist[i] < threshold
        dup[: i + 1] = False
        keep[dup] = False
    return lines_sorted[keep]


def nms_lines(
    lines: np.ndarray,
    resolution: int = 512,
    keep_cost: float = 10000.0,
) -> np.ndarray:
    """The reference 'NMS': grid junction SNAPPING, not suppression
    (nms.py:162-203). All line endpoints are binned into a
    ``resolution``^3 grid over their bbox; cells whose endpoint count is a
    local maximum of their 3^3 neighborhood become junction candidates;
    every line's two endpoints snap to the nearest candidate's grid
    coordinates. Lines are kept when the larger snap (squared) distance is
    under ``keep_cost`` (the reference uses 10000 = keep everything);
    near-duplicate lines collapse to identical snapped segments and the
    output gains shared-junction structure."""
    from scipy.spatial import cKDTree

    lines = lines.reshape(-1, 2, 3)
    if lines.shape[0] == 0:
        return lines
    pts = lines.reshape(-1, 3)
    bmin = pts.min(axis=0)
    bmax = pts.max(axis=0)
    delta = np.maximum((bmax - bmin) / (resolution - 1), 1e-12)
    idx = np.clip(
        np.round((pts - bmin) / delta).astype(np.int64), 0, resolution - 1
    )
    cells, counts = np.unique(idx, axis=0, return_counts=True)
    # sparse 3^3 max-pool: an occupied cell is a junction candidate when
    # its count >= every occupied neighbor's count (zero cells never
    # qualify: grid==max_pool fails where a positive neighbor exists and
    # max_pool>0 fails where none does — reference nms.py:181-183)
    cell_count = {tuple(c): int(n) for c, n in zip(cells, counts)}
    maxima = []
    for c, n in zip(cells, counts):
        best = True
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    if cell_count.get((c[0] + dx, c[1] + dy, c[2] + dz), 0) > n:
                        best = False
                        break
                if not best:
                    break
            if not best:
                break
        if best:
            maxima.append(c)
    points_uni = bmin + np.asarray(maxima, dtype=np.float64) * delta
    tree = cKDTree(points_uni)
    d0, i0 = tree.query(lines[:, 0])
    d1, i1 = tree.query(lines[:, 1])
    cost = np.maximum(d0**2, d1**2)
    keep = cost < keep_cost
    snapped = np.stack([points_uni[i0], points_uni[i1]], axis=1)
    return snapped[keep].astype(lines.dtype)


def merge_wireframes(
    line_sets: List[np.ndarray], rel_threshold: float = 0.05
) -> np.ndarray:
    """Sequential wireframe accumulation (reference
    wireframe-merge.py:195-209): starting from the first set, each
    existing line suppresses ONLY its single nearest incoming line, and
    only when that (endpoint-order-min mean) distance is under
    ``rel_threshold`` x the existing line's own LENGTH; every other
    incoming line is appended. Relative radii: long lines absorb over a
    wide radius, short lines barely at all."""
    sets = [l.reshape(-1, 2, 3) for l in line_sets if l.reshape(-1, 2, 3).shape[0]]
    if not sets:
        return np.zeros((0, 2, 3), dtype=np.float32)
    acc = sets[0]
    for new in sets[1:]:
        dis = line_pair_distance(acc, new)
        md = dis.min(axis=1)
        mid = dis.argmin(axis=1)
        length = np.linalg.norm(acc[:, 0] - acc[:, 1], axis=-1)
        is_exist = md < rel_threshold * length
        is_new = np.ones(new.shape[0], dtype=bool)
        is_new[mid[is_exist]] = False
        acc = np.concatenate([acc, new[is_new]], axis=0)
    return acc


def fuse_lines(
    scene,
    lines3d: np.ndarray,
    dis_threshold: float = 10.0,
    keep_score: float = 0.5,
    reference_scoring: bool = False,
) -> np.ndarray:
    """Cross-view detection-score fusion (reference evaluation/fusion.py:
    79-134): project each saved 3D line into every view, match it to its
    nearest 2D detection, accumulate that detection's confidence, and keep
    lines whose mean matched confidence exceeds ``keep_score``.

    The reference indexes the accumulated score by the ENUMERATION index
    of the matched-label set rather than the label itself (fusion.py:
    116-121), crediting lines with the wrong detection's confidence
    whenever matched indices are non-contiguous in a view. The default
    here uses the matched line's own confidence (the evident intent);
    ``reference_scoring=True`` reproduces the quirk bit-for-bit for
    output-level parity runs.
    """
    n = lines3d.shape[0]
    if n == 0:
        return lines3d
    scores = np.zeros(n)
    counts = np.zeros(n)
    for view in range(scene.n_images):
        nl = scene.n_lines[view]
        gt5 = scene.lines[view][:nl]
        if nl == 0:
            continue
        l2d = project_to_view(scene, view, lines3d).reshape(-1, 4)
        d1 = ((gt5[:, None, :4] - l2d[None]) ** 2).sum(-1)
        d2 = ((gt5[:, None, :4] - l2d[None][:, :, [2, 3, 0, 1]]) ** 2).sum(-1)
        dis = np.minimum(d1, d2)
        match_cost = dis.min(axis=0)
        match_idx = dis.argmin(axis=0)
        ok = match_cost < dis_threshold
        if reference_scoring:
            # fusion.py:116-121: scores[cur] += scors_gt[i] with i the
            # ENUMERATION index over the unique matched labels
            label_set = np.unique(match_idx[ok])
            for i, label in enumerate(label_set):
                cur = ok & (match_idx == label)
                scores[cur] += gt5[i, 4]
                counts[cur] += 1
        else:
            scores[ok] += gt5[match_idx[ok], 4]
            counts[ok] += 1
    mean_scores = scores / np.maximum(counts, 1)
    return lines3d[mean_scores > keep_score]


def refinement_recon(
    model,
    cfg,
    scene,
    lines3d: np.ndarray,
    scores: Optional[np.ndarray] = None,
    sdf_samples: int = 16,
    sdf_threshold: float = 0.01,
    score_threshold: float = 0.01,
    match_threshold: float = 10.0,
    verbose: bool = False,
) -> np.ndarray:
    """The reference refinement pass (refinement.py:95-181): lines whose
    max |sdf| over ``sdf_samples`` points exceeds ``sdf_threshold`` (or
    whose debug support score exceeds ``score_threshold``) are dropped;
    then, one view at a time, surviving lines are matched to the view's
    2D detections and every matched GROUP is replaced by its
    endpoint-order-aligned mean — cross-view consensus averaging;
    endpoints are never moved individually."""
    lines3d = np.asarray(lines3d, np.float32).reshape(-1, 2, 3)
    if lines3d.shape[0] == 0:
        return lines3d
    t = np.linspace(0.0, 1.0, sdf_samples, dtype=np.float32)[None, :, None]
    pts = lines3d[:, :1] + t * (lines3d[:, 1:] - lines3d[:, :1])
    sdf = model_sdf(model, cfg, pts.reshape(-1, 3)).reshape(lines3d.shape[0], sdf_samples)
    valid = np.abs(sdf).max(axis=1) < sdf_threshold
    if scores is not None:
        valid &= np.asarray(scores).reshape(-1) < score_threshold
    acc = lines3d[valid]
    if verbose:
        print(f"sdf/score filter: {lines3d.shape[0]} -> {acc.shape[0]}")

    h, w = scene.img_res
    for view in range(scene.n_images):
        if acc.shape[0] == 0:
            break
        nl = scene.n_lines[view]
        if nl == 0:
            continue
        gt = scene.lines[view][:nl][:, :4]
        l2d = project_to_view(scene, view, acc)  # (L, 2, 2)
        in_frame = (
            (l2d[..., 0] >= 0).all(-1) & (l2d[..., 0] <= w).all(-1)
            & (l2d[..., 1] >= 0).all(-1) & (l2d[..., 1] <= h).all(-1)
        )
        flat = l2d.reshape(-1, 4)
        d1 = ((gt[None] - flat[:, None]) ** 2).sum(-1)
        d2 = ((gt[None][:, :, [2, 3, 0, 1]] - flat[:, None]) ** 2).sum(-1)
        mind = np.minimum(d1, d2)
        mindis = mind.min(axis=1)
        mindix = mind.argmin(axis=1)
        mindis1 = d1[np.arange(acc.shape[0]), mindix]
        is_possible = in_frame & (mindis < match_threshold)
        if not is_possible.any():
            continue
        is_reverse = (mindis != mindis1) & is_possible
        wait = acc[is_possible].copy()
        rev = is_reverse[is_possible]
        wait[rev] = wait[rev][:, [1, 0]]
        groups = mindix[is_possible]
        means = []
        for g in np.unique(groups):
            means.append(wait[groups == g].mean(axis=0))
        acc = np.concatenate([acc[~is_possible], np.stack(means)], axis=0)
        if verbose:
            print(f"view {view}: {is_possible.sum()} matched -> "
                  f"{len(means)} group means ({acc.shape[0]} total)")
    return acc


def _project_point_to_line(segs4: np.ndarray, pts2: np.ndarray):
    """1-D coordinate of each point along its segment + orthogonal
    distance (reference dgrid.py:46-54)."""
    d = segs4[:, 2:] - segs4[:, :2]
    denom = np.maximum((d**2).sum(-1), 1e-12)
    t = ((pts2 - segs4[:, :2]) * d).sum(-1) / denom
    proj = segs4[:, :2] + t[:, None] * d
    return t, np.linalg.norm(proj - pts2, axis=-1)


def _segment_overlap(t1: np.ndarray, t2: np.ndarray) -> np.ndarray:
    """Overlap of [sorted(t1,t2)] with [0,1] (reference dgrid.py:56-61)."""
    lo = np.minimum(t1, t2)
    hi = np.maximum(t1, t2)
    return (hi > 0) * (lo < 1) * (np.minimum(hi, 1) - np.maximum(lo, 0))


def dgrid_recon(
    model,
    cfg,
    scene,
    resolution: int = 100,
    sdf_eps: float = 1e-2,
    grid_bounds=((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)),
    chunksize: int = 2048,
    orth_threshold: float = 1.0,
    overlap_threshold: float = 0.5,
    signature_merge: float = 0.75,
    verbose: bool = False,
) -> np.ndarray:
    """The reference grid distillation (dgrid.py:120-279): SDF-filter a
    ``resolution``^3 scene grid to surface points; for every view,
    evaluate the attraction field at each surface point's projected pixel
    and gate the produced line by orthogonal distance < 1 px and >50%
    overlap with that pixel's detected 2D line; accumulate per-point
    view-label signatures and per-view 3D lines; finally greedily cluster
    multi-view points whose signatures agree (mean over collected lines,
    clusters closed at >``signature_merge`` agreement). The reference
    script is unfinished (pdb + undefined variable after this stage);
    parity is through the ``lines_nms`` list it builds.

    grid_bounds: per-scene bbox (the reference reads DTU bbs.npz)."""
    lo, hi = (np.asarray(b, np.float32) for b in grid_bounds)
    axes = [np.linspace(lo[k], hi[k], resolution, dtype=np.float32)
            for k in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    sdf = []
    for c0 in range(0, len(pts), 50000):
        sdf.append(model_sdf(model, cfg, pts[c0 : c0 + 50000]))
    sdf = np.concatenate(sdf)
    pts = pts[np.abs(sdf) < sdf_eps]
    n_pts, n_views = pts.shape[0], scene.n_images
    if verbose:
        print(f"{n_pts} surface grid points")
    if n_pts == 0:
        return np.zeros((0, 2, 3), np.float32)

    h, w = scene.img_res
    points_cnt = np.zeros(n_pts, np.int64)
    points_view = np.full((n_pts, n_views), -1, np.int64)
    lines_view = np.full((n_pts, n_views, 2, 3), -1.0, np.float32)

    for view in range(n_views):
        nl = scene.n_lines[view]
        p2d = project_to_view(scene, view, pts)
        pl = np.round(p2d).astype(np.int64)
        is_in = (
            (pl[:, 0] >= 0) & (pl[:, 0] <= w - 1)
            & (pl[:, 1] >= 0) & (pl[:, 1] <= h - 1)
        )
        idx_p = np.nonzero(is_in)[0]
        if len(idx_p) == 0:
            continue
        pix = pl[idx_p, 1] * w + pl[idx_p, 0]
        lab = scene.labels[view][pix]
        msk = scene.mask[view][pix]

        uniq = np.unique(pix)
        override = np.zeros(h * w, dtype=bool)
        override[uniq] = True
        l3_u, l2_u, _, _ = view_field_lines(
            model, cfg, scene, view, chunksize, mask_override=override
        )
        pos = np.searchsorted(uniq, pix)
        l3 = l3_u[pos]
        l2 = l2_u[pos]

        valid_lab = (lab >= 0) & (lab < nl)
        gt4 = np.zeros((len(pix), 4), np.float32)
        gt4[valid_lab] = scene.lines[view][lab[valid_lab]][:, :4]
        t1, dor1 = _project_point_to_line(gt4, l2[:, :2])
        t2, dor2 = _project_point_to_line(gt4, l2[:, 2:])
        overlap = _segment_overlap(t1, t2)
        is_perfect = (
            (np.maximum(dor1, dor2) < orth_threshold)
            & (overlap > overlap_threshold)
            & valid_lab
        )
        points_cnt[idx_p] += (msk & is_perfect).astype(np.int64)
        points_view[idx_p, view] = np.where(is_perfect, lab, -1)
        ok = msk & is_perfect
        lines_view[idx_p[ok], view] = l3[ok]
        if verbose:
            print(f"view {view}: {ok.sum()} perfect points")

    sel = points_cnt > 1
    order = np.argsort(-points_cnt[sel], kind="stable")
    pv = points_view[sel][order]
    lv = lines_view[sel][order]
    visited = np.zeros(pv.shape[0], dtype=bool)
    lines_nms = []
    for i in range(pv.shape[0]):
        if visited[i]:
            continue
        collected = []
        flag = False
        denom = max(int((pv[i] > -1).sum()), 1)
        for j in range(i + 1, pv.shape[0]):
            identical = (pv[i] == pv[j]) & (pv[i] > -1)
            score = identical.sum() / denom
            if score == 0:
                continue
            collected.append(lv[i, identical])
            collected.append(lv[j, identical])
            if score > signature_merge:
                visited[j] = True
                flag = True
        if not collected:
            continue
        if flag:
            visited[i] = True
        lines_nms.append(np.concatenate(collected).mean(axis=0))
    if not lines_nms:
        return np.zeros((0, 2, 3), np.float32)
    return np.stack(lines_nms)


def grid_distill(
    lines: np.ndarray,
    cell_size: float = 0.02,
    angle_bins: int = 12,
    min_votes: int = 2,
) -> np.ndarray:
    """Grid-based line aggregation (reference evaluation/dgrid.py flavor):
    hash segments by quantized midpoint cell and direction bin, average
    each populated cell. A coarse, junction-free consolidation useful for
    dense multi-view line soups."""
    if lines.shape[0] == 0:
        return lines
    lines = lines.reshape(-1, 2, 3)
    mid = lines.mean(axis=1)
    d = lines[:, 1] - lines[:, 0]
    d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-9)
    # canonicalize direction hemisphere
    flip = d[:, 0] < 0
    d[flip] *= -1
    cell = np.floor(mid / cell_size).astype(np.int64)
    theta = np.arctan2(d[:, 1], d[:, 0])  # [-pi, pi]
    phi = np.arccos(np.clip(d[:, 2], -1, 1))
    tb = np.clip(((theta + np.pi) / (2 * np.pi) * angle_bins).astype(np.int64), 0, angle_bins - 1)
    pb = np.clip((phi / np.pi * angle_bins).astype(np.int64), 0, angle_bins - 1)
    key = np.stack([cell[:, 0], cell[:, 1], cell[:, 2], tb, pb], axis=1)
    uniq, inv, counts = np.unique(key, axis=0, return_inverse=True, return_counts=True)
    out = []
    for k in np.nonzero(counts >= min_votes)[0]:
        members = lines[inv == k]
        # align endpoint order to the first member before averaging
        ref = members[0]
        d1 = np.linalg.norm(members - ref[None], axis=-1).sum(-1)
        d2 = np.linalg.norm(members[:, [1, 0]] - ref[None], axis=-1).sum(-1)
        members = np.where((d2 < d1)[:, None, None], members[:, [1, 0]], members)
        out.append(members.mean(axis=0))
    if not out:
        return np.zeros((0, 2, 3), dtype=lines.dtype)
    # quantization splits clusters that straddle cell boundaries; merge the
    # per-cell means with a greedy suppression pass at the cell scale
    return greedy_suppress_lines(np.stack(out), threshold=cell_size)


def _cli_load_run(conf: str, checkpoint: str, data_root: str, device):
    import os.path as osp

    from ..data.datasets import load_scene_for_config
    from ..train.checkpoint import load_model
    from ..train.config import load_experiment_config

    assert osp.basename(conf) == "runconf.conf"
    rundir = osp.dirname(conf)
    cfg = load_experiment_config(conf)
    model, epoch = load_model(osp.join(rundir, "checkpoints"), checkpoint, cfg.model, device)
    scene = load_scene_for_config(cfg, data_root, distance_threshold=1.0)
    return rundir, cfg, model, epoch, scene


def main(argv=None):
    """CLI for the alternate distillation tools (reference
    evaluation/{wireframe,wireframe-merge,nms,fusion,refinement,dgrid}.py)."""
    import argparse
    import os
    import os.path as osp

    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_simple = sub.add_parser("simple", help="per-label mean distillation")
    p_simple.add_argument("--conf", required=True)
    p_simple.add_argument("--checkpoint", default="latest")
    p_simple.add_argument("--data_root", default="../data")
    p_simple.add_argument("--chunksize", type=int, default=2048)
    p_simple.add_argument("--dis-threshold", type=float, default=10.0)

    p_merge = sub.add_parser(
        "merge", help="sequential wireframe accumulation (wireframe-merge.py)"
    )
    p_merge.add_argument("inputs", nargs="+")
    p_merge.add_argument("--out", required=True)
    p_merge.add_argument("--threshold", type=float, default=0.05,
                         help="RELATIVE radius: x the existing line's length")

    p_nms = sub.add_parser(
        "nms", help="grid junction snapping (nms.py: endpoints snap to "
        "count local maxima of a 512^3 grid)"
    )
    p_nms.add_argument("--data", required=True)
    p_nms.add_argument("--out", required=True)
    p_nms.add_argument("--resolution", type=int, default=512)

    p_fuse = sub.add_parser("fuse", help="cross-view detection-score fusion")
    p_fuse.add_argument("--conf", required=True)
    p_fuse.add_argument("--checkpoint", default="latest")
    p_fuse.add_argument("--data", required=True, help="lines npz to re-score")
    p_fuse.add_argument("--data_root", default="../data")
    p_fuse.add_argument("--keep-score", type=float, default=0.5)
    p_fuse.add_argument("--reference-scoring", action="store_true",
                        help="reproduce fusion.py's enumeration-index "
                        "confidence lookup bit-for-bit")

    p_refine = sub.add_parser(
        "refine", help="sdf/score filter + per-view group averaging "
        "(refinement.py)"
    )
    p_refine.add_argument("--conf", required=True)
    p_refine.add_argument("--checkpoint", default="latest")
    p_refine.add_argument("--data", required=True,
                          help="debug npz (lines3d [+ scores])")
    p_refine.add_argument("--data_root", default="../data")
    p_refine.add_argument("--sdf-threshold", type=float, default=0.01)
    p_refine.add_argument("--score-threshold", type=float, default=0.01)

    p_dgrid = sub.add_parser(
        "dgrid", help="scene-grid surface points + label-signature "
        "clustering (dgrid.py)"
    )
    p_dgrid.add_argument("--conf", required=True)
    p_dgrid.add_argument("--checkpoint", default="latest")
    p_dgrid.add_argument("--data_root", default="../data")
    p_dgrid.add_argument("--resolution", type=int, default=100)
    p_dgrid.add_argument("--sdf-eps", type=float, default=1e-2)
    p_dgrid.add_argument("--bounds", type=float, nargs=6,
                         default=[-1, -1, -1, 1, 1, 1],
                         metavar=("X0", "Y0", "Z0", "X1", "Y1", "Z1"),
                         help="scene bbox (the reference reads DTU bbs.npz)")

    for p in (p_simple, p_fuse, p_refine, p_dgrid):
        p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    def load_lines(path):
        # reference artifacts store lines3d as an object array of
        # per-view (L, 2, 3) arrays (wireframe.py:183); flat arrays load
        # as-is (reference fusion.py:79-83 does the same dispatch)
        arr = np.load(path, allow_pickle=True)["lines3d"]
        if arr.dtype == object:
            arr = np.concatenate([np.asarray(a) for a in arr], axis=0)
        return np.asarray(arr, np.float32).reshape(-1, 2, 3)

    if args.cmd == "simple":
        rundir, cfg, model, epoch, scene = _cli_load_run(
            args.conf, args.checkpoint, args.data_root, args.device
        )
        lines = simple_recon(
            model, cfg.model, scene,
            chunksize=args.chunksize, dis_threshold=args.dis_threshold,
            verbose=True,
        )
        out_dir = osp.join(rundir, "wireframes")
        os.makedirs(out_dir, exist_ok=True)
        out = osp.join(out_dir, f"{args.checkpoint}-simple.npz")
        np.savez(out, lines3d=lines)
        print(f"{lines.shape[0]} lines -> {out}")
    elif args.cmd == "merge":
        sets = [load_lines(p) for p in args.inputs]
        merged = merge_wireframes(sets, rel_threshold=args.threshold)
        np.savez(args.out, lines3d=merged)
        print(f"{sum(s.shape[0] for s in sets)} -> {merged.shape[0]} lines -> {args.out}")
    elif args.cmd == "nms":
        lines = load_lines(args.data)
        kept = nms_lines(lines, resolution=args.resolution)
        np.savez(args.out, lines3d=kept)
        print(f"{lines.shape[0]} -> {kept.shape[0]} snapped lines -> {args.out}")
    elif args.cmd == "fuse":
        rundir, cfg, model, epoch, scene = _cli_load_run(
            args.conf, args.checkpoint, args.data_root, args.device
        )
        lines = load_lines(args.data)
        fused = fuse_lines(
            scene, lines, keep_score=args.keep_score,
            reference_scoring=args.reference_scoring,
        )
        out = args.data.replace(".npz", "-fused.npz")
        np.savez(out, lines3d=fused)
        print(f"{lines.shape[0]} -> {fused.shape[0]} lines -> {out}")
    elif args.cmd == "refine":
        rundir, cfg, model, epoch, scene = _cli_load_run(
            args.conf, args.checkpoint, args.data_root, args.device
        )
        data = np.load(args.data, allow_pickle=True)
        lines = load_lines(args.data)
        scores = data["scores"] if "scores" in data.files else None
        refined = refinement_recon(
            model, cfg.model, scene, lines, scores=scores,
            sdf_threshold=args.sdf_threshold,
            score_threshold=args.score_threshold, verbose=True,
        )
        out = args.data.replace(".npz", "-refined.npz")
        np.savez(out, lines3d=refined)
        print(f"{lines.shape[0]} -> {refined.shape[0]} lines -> {out}")
    elif args.cmd == "dgrid":
        rundir, cfg, model, epoch, scene = _cli_load_run(
            args.conf, args.checkpoint, args.data_root, args.device
        )
        b = args.bounds
        lines = dgrid_recon(
            model, cfg.model, scene, resolution=args.resolution,
            sdf_eps=args.sdf_eps, grid_bounds=(b[:3], b[3:]), verbose=True,
        )
        out_dir = osp.join(rundir, "wireframes")
        os.makedirs(out_dir, exist_ok=True)
        out = osp.join(out_dir, f"{args.checkpoint}-dgrid.npz")
        np.savez(out, lines3d=lines)
        print(f"{lines.shape[0]} clustered lines -> {out}")


def refine_lines_sdf(
    model, cfg, lines: np.ndarray, n_steps: int = 1, keep_threshold: float = 0.05
) -> np.ndarray:
    """Newton-project line endpoints onto the SDF surface and drop lines
    whose endpoints stay far from it (reference evaluation/refinement.py
    flavor of the finalization's junction refinement); the gradient by
    autograd."""
    from ..fields.mlp import implicit_sdf_feat_grad

    p0 = next(model.parameters())
    pts = torch.as_tensor(lines.reshape(-1, 3), dtype=p0.dtype, device=p0.device)
    with torch.no_grad():
        for _ in range(n_steps):
            sdf, _, grad = implicit_sdf_feat_grad(model.implicit, pts, cfg.implicit)
            pts = pts - sdf * grad
    out = pts.cpu().numpy()
    final_sdf = model_sdf(model, cfg, out).reshape(-1, 2)
    keep = (np.abs(final_sdf) < keep_threshold).all(axis=1)
    return out.reshape(-1, 2, 3)[keep]


if __name__ == "__main__":
    main()
