"""Wireframe ACC/COMP evaluations on DTU / BMVS / ScanNet (port of
neat_tpu/evaluation/eval_lsr.py, numpy and scipy only: the same numbers on
the same files).

    python -m neat_tpu_torch.evaluation.eval_lsr --mode junctions|lines \
        --data <rundir>/wireframes/<name>-wfi_checked.npz --scan <scan> \
        --dataset_dir <dir holding ObsMask/ and Points/stl/> --cameras <scan dir>/cameras.npz

Parity targets:
  * eval-wfr-dtu.py:30-124 — junction ACC/COMP: unique wfi_checked
    endpoints vs GT STL points, ObsMask/Plane filtered, max_dist 20.
    NOTE the reference DISABLES the radius-0.2 downsample for junctions
    (eval-wfr-dtu.py:46: `data_down = data_pcd#[mask]`) — all endpoints
    are scored;
  * eval-lsr-dtu.py:64-150 — line ACC/COMP: each predicted segment
    resampled at 32 points, radius-0.2 downsample, same masking and
    distances;
  * eval-lsr-bmvs.py:80-124 — lines without the DTU masks AND without
    the downsample ("Note: use all line pts", :88-90);
  * eval-lsr-scannet.py:42-140 — a DIFFERENT protocol: predictions
    mapped by per-scan x/scale + offset, GT = gt.obj mesh vertices
    voxel-downsampled at 0.02 m, no prediction downsample, unclipped
    mean chamfer terms plus Prec/Recall/F-score at 0.05 m.

DTU/BMVS reuse the point-set scorer in eval_dtu.py; ScanNet has its own.
"""

from __future__ import annotations

import argparse
import pickle
from typing import Dict, Optional

import numpy as np

from .eval_dtu import eval_dtu_points


def resample_lines(lines: np.ndarray, n_points: int = 32) -> np.ndarray:
    """(L, 2, 3) segments -> (L * n_points, 3) evenly spaced samples in the
    reference's exact ORDER: p(t) = start*t + end*(1-t) with t ascending
    (eval-lsr-dtu.py:72-77), i.e. each line is walked from its second
    endpoint to its first. Order matters because the DTU protocol then
    shuffles + greedily radius-downsamples (order-sensitive), so executed
    parity needs the identical sequence, not just the identical set."""
    t = np.linspace(0.0, 1.0, n_points)[None, :, None]
    pts = lines[:, :1] * t + lines[:, 1:] * (1 - t)
    return pts.reshape(-1, 3)


def _load_pred_lines(data: str, key: str = "lines3d_wfi_checked") -> np.ndarray:
    if data.endswith(".npz"):
        return np.load(data)["lines3d"].reshape(-1, 2, 3)
    with open(data, "rb") as f:
        return np.asarray(pickle.load(f)[key]).reshape(-1, 2, 3)


def _apply_scale(points: np.ndarray, scale_mat: Optional[np.ndarray]) -> np.ndarray:
    if scale_mat is None:
        return points
    return points @ scale_mat[:3, :3].T + scale_mat[:3, 3]


def eval_wfr_junctions(
    data: str,
    stl: np.ndarray,
    scale_mat: Optional[np.ndarray] = None,
    obs_mask=None,
    bb=None,
    res: float = 10.0,
    ground_plane=None,
    max_dist: float = 20.0,
    downsample_radius: float = 0.0,
) -> Dict[str, float]:
    """Junction ACC/COMP: unique endpoints of the checked wireframe.
    No downsample by default — the reference scores every endpoint
    (eval-wfr-dtu.py:46 keeps `data_pcd` and comments out the mask)."""
    lines = _load_pred_lines(data)
    endpoints = np.unique(lines.reshape(-1, 3), axis=0)
    endpoints = _apply_scale(endpoints, scale_mat)
    return eval_dtu_points(
        endpoints, stl, obs_mask=obs_mask, bb=bb, res=res,
        ground_plane=ground_plane, max_dist=max_dist,
        downsample_radius=downsample_radius,
        grid_cast_f32=True,  # eval-wfr-dtu.py:55 rounds the grid in f32
    )


def eval_lsr_lines(
    data: str,
    stl: np.ndarray,
    scale_mat: Optional[np.ndarray] = None,
    n_points: int = 32,
    obs_mask=None,
    bb=None,
    res: float = 10.0,
    ground_plane=None,
    max_dist: float = 20.0,
    downsample_radius: float = 0.2,
) -> Dict[str, float]:
    """Line ACC/COMP: segments resampled at n_points."""
    lines = _load_pred_lines(data)
    lines = _apply_scale(lines.reshape(-1, 3), scale_mat).reshape(-1, 2, 3)
    pts = resample_lines(lines, n_points)
    return eval_dtu_points(
        pts, stl, obs_mask=obs_mask, bb=bb, res=res,
        ground_plane=ground_plane, max_dist=max_dist,
        downsample_radius=downsample_radius,
        grid_cast_f32=True,  # eval-lsr-dtu.py:106 rounds the grid in f32
    )


def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
    """Centroid-per-voxel downsample with open3d's exact bucketing: voxel
    indices are taken relative to ``min_bound - voxel/2`` (open3d C++
    VoxelDownSample), one averaged point per occupied voxel. Reference
    eval-lsr-scannet.py:46-48 applies it to the GT mesh vertices at
    0.02 m."""
    if voxel <= 0 or len(points) == 0:
        return points
    voxel_min = points.min(axis=0) - voxel * 0.5
    keys = np.floor((points - voxel_min) / voxel).astype(np.int64)
    _, inv, counts = np.unique(
        keys, axis=0, return_inverse=True, return_counts=True
    )
    sums = np.zeros((len(counts), 3), dtype=np.float64)
    np.add.at(sums, inv, points)
    return (sums / counts[:, None]).astype(points.dtype)


# reference eval-lsr-scannet.py:81-88 — per-scan normalization constants
SCANNET_SCALE_OFFSET = {
    "0084_00": (0.44963, np.array([1.23815, 2.57319, 1.38001])),
    "0616_00": (0.38626, np.array([2.84253, 2.14299, 1.38729])),
}


def eval_scannet_lines(
    data: str,
    gt_vertices: np.ndarray,
    scale: float,
    offset: np.ndarray,
    n_points: int = 32,
    threshold: float = 0.05,
    voxel: float = 0.02,
) -> Dict[str, float]:
    """The ScanNet wireframe protocol (reference eval-lsr-scannet.py:
    42-140): predictions resampled at 32 pts and mapped by x/scale +
    offset (NO downsample), GT mesh vertices voxel-downsampled at
    0.02 m; unclipped mean chamfer terms + Prec/Recall/F-score at 0.05 m."""
    from scipy.spatial import cKDTree

    lines = _load_pred_lines(data)
    pts = resample_lines(lines, n_points) / scale + offset.reshape(1, 3)
    gt = voxel_downsample(np.asarray(gt_vertices, np.float64), voxel)

    d_pred_to_gt = cKDTree(gt).query(pts, k=1)[0]  # accuracy direction
    d_gt_to_pred = cKDTree(pts).query(gt, k=1)[0]  # completeness direction
    precision = float((d_pred_to_gt < threshold).mean())
    recall = float((d_gt_to_pred < threshold).mean())
    f = 2 * precision * recall / max(precision + recall, 1e-12)
    return {
        "accuracy_d2s": float(d_pred_to_gt.mean()),
        "completeness_s2d": float(d_gt_to_pred.mean()),
        "overall": 0.5 * (float(d_pred_to_gt.mean()) + float(d_gt_to_pred.mean())),
        "precision": precision,
        "recall": recall,
        "fscore": f,
    }


def load_obj_vertices(path: str) -> np.ndarray:
    """Vertices of a Wavefront .obj (the ScanNet gt.obj consumer)."""
    verts = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(v) for v in line.split()[1:4]])
    return np.asarray(verts, dtype=np.float64)


def main(argv=None) -> Dict[str, float]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", type=str, required=True)
    parser.add_argument("--scan", type=str, required=True)
    parser.add_argument("--dataset_dir", type=str, required=True)
    parser.add_argument("--mode", choices=["junctions", "lines"], default="lines")
    parser.add_argument(
        "--protocol", choices=["dtu", "bmvs", "scannet"], default="dtu",
        help="dtu: ObsMask/Plane masks + radius-0.2 line downsample; "
        "bmvs: no masks, all line points; scannet: x/scale+offset map, "
        "voxel-0.02 GT, Prec/Recall/F-score at 0.05",
    )
    parser.add_argument("--no-masks", action="store_true",
                        help="deprecated alias for --protocol bmvs")
    parser.add_argument("--stl", type=str, default=None,
                        help="GT point-cloud ply (BMVS; default: the DTU "
                        "Points/stl layout under --dataset_dir)")
    parser.add_argument(
        "--cameras", type=str, default=None,
        help="scene cameras.npz: applies scale_mat_0 to map normalized "
        "predictions into the GT frame (reference eval-lsr-dtu.py:50-80)",
    )
    parser.add_argument("--scale", type=float, default=None,
                        help="scannet: override the per-scan scale")
    parser.add_argument("--offset", type=float, nargs=3, default=None,
                        help="scannet: override the per-scan offset")
    args = parser.parse_args(argv)
    protocol = "bmvs" if args.no_masks and args.protocol == "dtu" else args.protocol

    if protocol == "scannet":
        if args.scale is not None and args.offset is not None:
            scale, offset = args.scale, np.asarray(args.offset)
        else:
            if args.scan not in SCANNET_SCALE_OFFSET:
                raise SystemExit(
                    f"no scale/offset for scan {args.scan}; pass --scale/--offset"
                )
            scale, offset = SCANNET_SCALE_OFFSET[args.scan]
        gt = load_obj_vertices(f"{args.dataset_dir}/{args.scan}/gt.obj")
        out = eval_scannet_lines(args.data, gt, scale, offset)
        for k, v in out.items():
            print(f"{k}: {v:.4f}")
        return out

    from scipy.io import loadmat
    from ..viz.mesh import load_ply

    stl_path = args.stl or f"{args.dataset_dir}/Points/stl/stl{int(args.scan):03}_total.ply"
    # float64 like the reference's open3d read (see eval_dtu.eval_dtu_mesh)
    stl = load_ply(stl_path)[0].astype(np.float64)
    kwargs = {}
    if args.cameras:
        kwargs["scale_mat"] = np.load(args.cameras)["scale_mat_0"]
    if protocol == "dtu":
        mat = loadmat(f"{args.dataset_dir}/ObsMask/ObsMask{args.scan}_10.mat")
        kwargs.update(
            obs_mask=mat["ObsMask"], bb=mat["BB"], res=float(np.asarray(mat["Res"]).item()),
            ground_plane=loadmat(f"{args.dataset_dir}/ObsMask/Plane{args.scan}.mat")[
                "P"
            ].reshape(-1),
        )
    elif args.mode == "lines":
        # BMVS scores ALL resampled line points (eval-lsr-bmvs.py:88-90)
        kwargs["downsample_radius"] = 0.0
    fn = eval_wfr_junctions if args.mode == "junctions" else eval_lsr_lines
    out = fn(args.data, stl, **kwargs)
    print(out["accuracy_d2s"], out["completeness_s2d"], out["overall"])
    return out


if __name__ == "__main__":
    main()
