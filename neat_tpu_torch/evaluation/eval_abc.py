"""ABC wireframe evaluation: junction & line precision/recall vs CAD GT
(port of neat_tpu/evaluation/eval_abc.py, numpy and scipy only: the same
numbers on the same pickle).

    python -m neat_tpu_torch.evaluation.eval_abc --data <run>/wireframes/<name>-neat.pkl \
        --scan <data_root>/abc/<scan>

Parity target: reference code/evaluation/eval-abc.py:22-130 — scale the
predicted junctions/lines into the CAD frame via offset_scale.txt, match
with Hungarian assignment, report precision/recall at thresholds
{0.01, 0.02, 0.05} x scale; prints the same LaTeX-style rows.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import pickle
from typing import Dict, Optional, Sequence

import numpy as np

THRESHOLDS = (0.01, 0.02, 0.05)


def load_scale_mat(scan_dir: str) -> np.ndarray:
    """offset_scale.txt -> the 4x4 scale matrix of the reference eval
    (eval-abc.py:31-37; the reference hard-requires the file). When it is
    missing (the shipped toy scene has none), the transform is
    reconstructed from the GT bounding box under the BBOX-CENTERED
    convention: x_gt = x_norm * max_extent + bbox_center. Note this is
    NOT the x/scale - 0.5 mapping in the scratch render.py (:8-18) —
    that script's convention would place this scene's junctions
    off-center, while the shipped cameras.npz/images are centered; the
    bbox-centered inverse is validated end-to-end by exact GT recovery
    (P = R = 1.000) from trained runs and by the shipped debug renders
    (tests/test_debug_artifacts.py)."""
    path = osp.join(scan_dir, "offset_scale.txt")
    if osp.exists(path):
        with open(path) as f:
            vals = f.read().split()
        off = [float(v) for v in vals[:3]]
        scale = float(vals[-1])
        m = np.eye(4)
        m[0, 0] = m[1, 1] = m[2, 2] = 1.0 / scale
        m[0, 3], m[1, 3], m[2, 3] = -off[0], -off[1], -off[2]
        return m
    with open(osp.join(scan_dir, "lines.json")) as f:
        gt = json.load(f)
    j = np.asarray(gt["junctions"])
    extent = (j.max(0) - j.min(0)).max()
    # the scene trains in bbox-centered normalized coords:
    # x_norm = (x_gt - bbox_center) / extent  =>  x_gt = x_norm*extent + center
    m = np.eye(4)
    m[0, 0] = m[1, 1] = m[2, 2] = extent
    m[:3, 3] = 0.5 * (j.min(0) + j.max(0))
    return m


def _pr(cost: np.ndarray, assign, n_gt: int, n_pred: int, thresholds, scale):
    matched_cost = cost[assign]
    precision, recall = [], []
    for t in thresholds:
        correct = (matched_cost < t * scale).sum()
        recall.append(correct / max(n_gt, 1))
        precision.append(correct / max(n_pred, 1))
    return precision, recall


def eval_abc(
    data: str,
    scan_dir: str,
    thresholds: Sequence[float] = THRESHOLDS,
    verbose: bool = True,
) -> Dict[str, list]:
    """data: the finalization -neat.pkl result (path, or the already-
    loaded results dict); scan_dir: ABC scene dir with lines.json
    (+ optional offset_scale.txt)."""
    from scipy.optimize import linear_sum_assignment

    if isinstance(data, dict):
        results = data
    else:
        with open(data, "rb") as f:
            results = pickle.load(f)

    with open(osp.join(scan_dir, "lines.json")) as f:
        gt = json.load(f)
    junctions_gt = np.asarray(gt["junctions"])
    edges = np.asarray(gt["lines"])
    lines_gt = junctions_gt[edges]  # (L, 2, 3)

    scale_mat = load_scale_mat(scan_dir)
    global_scale = scale_mat[0, 0]

    jp = np.asarray(results["junctions3d_initial"])
    jp_scaled = jp @ scale_mat[:3, :3].T + scale_mat[:3, 3]
    cost = np.linalg.norm(jp_scaled[:, None] - junctions_gt[None], axis=-1)
    assign = linear_sum_assignment(cost)
    j_prec, j_rec = _pr(
        cost, assign, junctions_gt.shape[0], jp.shape[0], thresholds, global_scale
    )

    lp = np.asarray(results["lines3d_wfi_checked"]).reshape(-1, 2, 3)
    lp_scaled = (lp.reshape(-1, 3) @ scale_mat[:3, :3].T + scale_mat[:3, 3]).reshape(
        -1, 2, 3
    )
    c1 = np.linalg.norm(lp_scaled[:, None] - lines_gt[None], axis=-1).mean(-1)
    c2 = np.linalg.norm(lp_scaled[:, None] - lines_gt[None, :, [1, 0]], axis=-1).mean(
        -1
    )
    lcost = np.minimum(c1, c2)
    lassign = linear_sum_assignment(lcost)
    l_prec, l_rec = _pr(
        lcost, lassign, lines_gt.shape[0], lp.shape[0], thresholds, global_scale
    )

    if verbose:
        print(" & ".join(f"{v:.3f}" for v in j_prec + j_rec))
        print(" & ".join(f"{v:.3f}" for v in l_prec + l_rec))

    return {
        "junction_precision": j_prec,
        "junction_recall": j_rec,
        "line_precision": l_prec,
        "line_recall": l_rec,
        "thresholds": list(thresholds),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description="neat_tpu_torch ABC wireframe precision / recall")
    parser.add_argument("--data", type=str, required=True, help="finalized -neat.pkl")
    parser.add_argument("--scan", type=str, required=True, help="ABC scan dir")
    args = parser.parse_args(argv)
    return eval_abc(args.data, args.scan)


if __name__ == "__main__":
    main()
