"""DTU surface evaluation: official-style ACC (d2s) / COMP (s2d) (port of
neat_tpu/evaluation/eval_dtu.py, numpy and scipy only: the same numbers on
the same files).

    python -m neat_tpu_torch.evaluation.eval_dtu --data <rundir>/evaluation/surface_<epoch>.ply \
        --scan <scan> --dataset_dir <dir holding ObsMask/ and Points/stl/>

Parity target: reference code/evaluation/eval-dtu.py:26-158 — sample points
from the predicted mesh (or use a point set), greedy radius-0.2 downsample,
ObsMask bounding + grid mask, distance to GT STL (ACC), Plane-filtered
STL-to-data distance (COMP), distances clipped at max_dist=20.

Uses scipy cKDTree instead of open3d/sklearn (same metric definitions).
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np


def downsample_points(points: np.ndarray, radius: float = 0.2, seed: int = 0) -> np.ndarray:
    """Greedy radius downsample after a random shuffle (reference
    eval-dtu.py:80-94). radius <= 0 is a no-op (the junction/BMVS line
    protocols score ALL points — eval-wfr-dtu.py:46, eval-lsr-bmvs.py:88)."""
    from scipy.spatial import cKDTree

    if radius <= 0:
        return points
    rng = np.random.default_rng(seed)
    pts = points.copy()
    rng.shuffle(pts, axis=0)
    tree = cKDTree(pts)
    mask = np.ones(len(pts), dtype=bool)
    neighbor_lists = tree.query_ball_point(pts, r=radius)
    for i, neigh in enumerate(neighbor_lists):
        if mask[i]:
            mask[neigh] = False
            mask[i] = True
    return pts[mask]


def eval_dtu_points(
    data_pcd: np.ndarray,
    stl: np.ndarray,
    obs_mask: Optional[np.ndarray] = None,
    bb: Optional[np.ndarray] = None,
    res: float = 10.0,
    ground_plane: Optional[np.ndarray] = None,
    downsample_radius: float = 0.2,
    max_dist: float = 20.0,
    patch_size: float = 60.0,
    grid_cast_f32: bool = False,
) -> Dict[str, float]:
    """Compute ACC/COMP between a predicted point set and the GT STL points.

    obs_mask: (X, Y, Z) bool grid with bb (2, 3) bounds and res spacing;
    ground_plane: (4,) plane coefficients. Both optional (skipped if None),
    matching the reference protocol when masks are present.

    grid_cast_f32: the wireframe protocols round the ObsMask grid index in
    float32 (eval-wfr-dtu.py:55, eval-lsr-dtu.py:106) while the surface
    protocol rounds in float64 (eval-dtu.py:106) — replicated exactly so
    boundary points land in the same cells.
    """
    from scipy.spatial import cKDTree

    data_down = downsample_points(data_pcd, downsample_radius)

    data_in = data_down
    if obs_mask is not None and bb is not None:
        bb = bb.astype(np.float32)
        inbound = (
            (data_down >= bb[:1] - patch_size) & (data_down < bb[1:] + patch_size * 2)
        ).sum(-1) == 3
        data_in = data_down[inbound]
        ref = (data_in - bb[:1]) / res
        if grid_cast_f32:
            ref = ref.astype(np.float32)
        grid = np.around(ref).astype(np.int32)
        grid_in = (
            (grid >= 0) & (grid < np.expand_dims(obs_mask.shape, 0))
        ).sum(-1) == 3
        gi = grid[grid_in]
        in_obs = obs_mask[gi[:, 0], gi[:, 1], gi[:, 2]].astype(bool)
        data_in_obs = data_in[grid_in][in_obs]
    else:
        data_in_obs = data_in

    tree_stl = cKDTree(stl)
    d2s, _ = tree_stl.query(data_in_obs, k=1)
    mean_d2s = d2s[d2s < max_dist].mean() if len(d2s) else float("inf")

    stl_above = stl
    if ground_plane is not None:
        hom = np.concatenate([stl, np.ones_like(stl[:, :1])], axis=-1)
        stl_above = stl[(ground_plane.reshape(1, 4) * hom).sum(-1) > 0]

    tree_data = cKDTree(data_in)
    s2d, _ = tree_data.query(stl_above, k=1)
    mean_s2d = s2d[s2d < max_dist].mean() if len(s2d) else float("inf")

    return {
        "accuracy_d2s": float(mean_d2s),
        "completeness_s2d": float(mean_s2d),
        "overall": float((mean_d2s + mean_s2d) / 2),
    }


def eval_dtu_mesh(
    mesh_path: str,
    dataset_dir: str,
    scan: int,
    sample_density: float = 0.2,
    **kwargs,
) -> Dict[str, float]:
    """Mesh flavor: convert the predicted mesh to points the reference way
    (deterministic per-triangle grid at ``sample_density`` spacing PLUS
    all vertices — eval-dtu.py:46-71; random area-weighted sampling
    under-densifies large meshes and shifts COMP), load the official
    ObsMask / Plane mats and the GT STL point cloud, then score."""
    from scipy.io import loadmat
    from ..viz.mesh import grid_sample_mesh, load_ply

    # float64 throughout: the reference pipeline reads via open3d (float64
    # vertices) and computes thr/floor in float64 (eval-dtu.py:48,63-65);
    # float32 arithmetic can flip a floor() and change the sample count
    verts, faces = load_ply(mesh_path)
    verts = verts.astype(np.float64)
    if len(faces):
        data_pcd = grid_sample_mesh(verts, faces, sample_density)
    else:
        data_pcd = verts

    mat = loadmat(f"{dataset_dir}/ObsMask/ObsMask{scan}_10.mat")
    obs_mask, bb, res = mat["ObsMask"], mat["BB"], float(np.asarray(mat["Res"]).item())
    plane = loadmat(f"{dataset_dir}/ObsMask/Plane{scan}.mat")["P"].reshape(-1)

    stl_verts, _ = load_ply(f"{dataset_dir}/Points/stl/stl{scan:03}_total.ply")
    stl_verts = stl_verts.astype(np.float64)
    return eval_dtu_points(
        data_pcd, stl_verts, obs_mask=obs_mask, bb=bb, res=res,
        ground_plane=plane, **kwargs,
    )


def main(argv=None) -> Dict[str, float]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", type=str, required=True, help="predicted mesh .ply")
    parser.add_argument("--scan", type=int, required=True)
    parser.add_argument("--dataset_dir", type=str, required=True)
    parser.add_argument("--max_dist", type=float, default=20.0)
    args = parser.parse_args(argv)
    out = eval_dtu_mesh(args.data, args.dataset_dir, args.scan, max_dist=args.max_dist)
    print(out["accuracy_d2s"], out["completeness_s2d"], out["overall"])
    return out


if __name__ == "__main__":
    main()
