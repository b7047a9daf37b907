"""Detectability of the ground-truth CAD wireframe against the per-view
HAWP detections (port of neat_tpu/evaluation/abc_analysis.py).

    python -m neat_tpu_torch.evaluation.abc_analysis --scan <data_root>/abc/<scan> \
        [--mesh <mesh.obj>] [--out <file>.npz]

For every view: project the GT junctions and lines into the image, decide
their visibility (the frustum test, and with a triangle mesh of the object
an occlusion test by ray casting), match the HAWP detections to the
projected GT by Hungarian assignment, and count each element's hits. The
result says what fraction of the wireframe the 2D detector could
supervise at all: the upper bound on the pipeline's recall.

The projections and the ray casting (a Moller-Trumbore intersector over the
OBJ mesh, rays x triangles) run in torch on ``device``, the card by
default, in f64; the matching is scipy's. Without a mesh file the occlusion
test is skipped and visibility is the frustum test alone. Results are
printed and written to an npz.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.camera import get_camera_params, project2d
from .eval_abc import load_scale_mat


def _f64(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64), device=device)


def load_obj_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal OBJ reader -> (vertices (V, 3), faces (F, 3) int). Supports
    triangle and polygon faces (fan-triangulated)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(v) for v in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                for i in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[i], idx[i + 1]])
    return np.asarray(verts, dtype=np.float64), np.asarray(faces, dtype=np.int64)


def ray_cast_first_hit(
    origins: torch.Tensor,
    dirs: torch.Tensor,
    verts: torch.Tensor,
    faces: torch.Tensor,
    chunk: int = 512,
) -> torch.Tensor:
    """First-hit distances t of rays (N, 3) against a triangle mesh
    (Moller-Trumbore, rays x triangles in chunks of ``chunk`` rays), on the
    tensors' device. Returns (N,) with +inf for misses."""
    v0 = verts[faces[:, 0]]
    e1 = verts[faces[:, 1]] - v0
    e2 = verts[faces[:, 2]] - v0
    t_out = torch.full((origins.shape[0],), float("inf"), dtype=origins.dtype, device=origins.device)
    for c0 in range(0, origins.shape[0], chunk):
        o = origins[c0 : c0 + chunk, None, :]  # (n, 1, 3)
        d = dirs[c0 : c0 + chunk, None, :].expand(-1, e2.shape[0], 3)
        pvec = torch.linalg.cross(d, e2[None].expand_as(d))  # (n, F, 3)
        det = torch.einsum("nfc,fc->nf", pvec, e1)
        nonzero = torch.abs(det) > 1e-12
        inv_det = torch.where(nonzero, 1.0 / det, torch.zeros_like(det))
        tvec = o - v0[None]
        u = torch.einsum("nfc,nfc->nf", tvec, pvec) * inv_det
        qvec = torch.linalg.cross(tvec, e1[None].expand_as(tvec))
        v = torch.einsum("nfc,nfc->nf", qvec, d) * inv_det
        t = torch.einsum("nfc,fc->nf", qvec, e2) * inv_det
        hit = nonzero & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-6)
        t = torch.where(hit, t, torch.full_like(t, float("inf")))
        t_out[c0 : c0 + chunk] = t.min(dim=1).values
    return t_out


def _cast_check(
    points2d: np.ndarray,
    points3d: np.ndarray,
    intrinsics: np.ndarray,
    pose: np.ndarray,
    mesh: Optional[Tuple[torch.Tensor, torch.Tensor]],
    tol: float,
    device="cuda",
) -> np.ndarray:
    """Visibility by casting pixel rays and requiring the first mesh hit to
    land on the query point (reference abc-analysis.py:44-57)."""
    if mesh is None:
        return np.ones(points2d.shape[0], dtype=bool)
    ray_dirs, cam_loc = get_camera_params(
        _f64(points2d, device)[None], _f64(pose, device)[None], _f64(intrinsics, device)[None]
    )
    ray_dirs = ray_dirs[0]
    cam_loc = cam_loc[0].expand_as(ray_dirs)
    t = ray_cast_first_hit(cam_loc, ray_dirs, *mesh)
    cast_pts = cam_loc + ray_dirs * t[:, None]
    return (torch.linalg.norm(cast_pts - _f64(points3d, device), dim=-1) < tol).cpu().numpy()


def analyze_detectability(
    scene,
    scan_dir: str,
    mesh_path: Optional[str] = None,
    match_threshold: float = 20.0,
    score_threshold: float = 0.05,
    verbose: bool = True,
    device="cuda",
):
    """Run the per-view GT-vs-detection matching sweep on ``device``.

    Returns a dict with per-element hit counts and per-view hit rates;
    mirrors the accumulators of reference abc-analysis.py:110-183.
    """
    from scipy.optimize import linear_sum_assignment

    with open(osp.join(scan_dir, "lines.json")) as f:
        gt = json.load(f)
    inv_scale = np.linalg.inv(load_scale_mat(scan_dir))
    junctions = np.asarray(gt["junctions"], dtype=np.float64)
    junctions = (inv_scale[:3, :3] @ junctions.T + inv_scale[:3, 3:]).T
    edges = np.asarray(gt["lines"], dtype=np.int64)
    lines3d = junctions[edges]  # (L, 2, 3)

    mesh = None
    if mesh_path and osp.exists(mesh_path):
        verts, faces = load_obj_mesh(mesh_path)
        verts = (inv_scale[:3, :3] @ verts.T + inv_scale[:3, 3:]).T
        mesh = (torch.as_tensor(verts, device=device), torch.as_tensor(faces, device=device))

    h, w = scene.img_res
    junction_hits = np.zeros(junctions.shape[0], dtype=np.int64)
    line_hits = np.zeros(lines3d.shape[0], dtype=np.int64)
    j_rates, l_rates = [], []
    f64 = lambda a: _f64(a, device)

    for view in range(scene.n_images):
        K = scene.intrinsics[view][:3, :3]
        w2c = np.linalg.inv(scene.pose[view])
        R, t = w2c[:3, :3], w2c[:3, 3]

        j2d = project2d(f64(K), f64(R), f64(t), f64(junctions)).cpu().numpy()
        in_frame = (
            (j2d[:, 0] >= 0) & (j2d[:, 0] < w) & (j2d[:, 1] >= 0) & (j2d[:, 1] < h)
        )
        # junction visibility tolerance 1e-4 = the reference's
        # ray_casting_check default (abc-analysis.py:44); endpoints below
        # use the looser 0.1 it passes explicitly (:139-140)
        vis = in_frame & _cast_check(
            j2d, junctions, scene.intrinsics[view], scene.pose[view], mesh, tol=1e-4, device=device
        )

        det_j = scene.verts2d[view][scene.verts_mask[view]]
        j_hits_this_view = 0
        if det_j.shape[0] and vis.sum():
            cost = np.linalg.norm(det_j[:, None] - j2d[None], axis=-1)
            ri, ci = linear_sum_assignment(cost)
            hit = (cost[ri, ci] < match_threshold) & vis[ci]
            junction_hits[ci[hit]] += 1
            j_hits_this_view = int(hit.sum())
        # every view contributes a rate — the reference divides the summed
        # rates by len(eval_dataloader) (abc-analysis.py:143-144,177-178),
        # counting detection-less / all-occluded views as 0
        j_rates.append(j_hits_this_view / max(int(vis.sum()), 1))

        l2d = project2d(f64(K), f64(R), f64(t), f64(lines3d)).cpu().numpy().reshape(-1, 4)
        lin = (
            (l2d[:, 0] >= 0) & (l2d[:, 0] < w) & (l2d[:, 1] >= 0) & (l2d[:, 1] < h)
            & (l2d[:, 2] >= 0) & (l2d[:, 2] < w) & (l2d[:, 3] >= 0) & (l2d[:, 3] < h)
        )
        vis_a = _cast_check(
            l2d[:, :2], lines3d[:, 0], scene.intrinsics[view], scene.pose[view], mesh, tol=0.1, device=device
        )
        vis_b = _cast_check(
            l2d[:, 2:], lines3d[:, 1], scene.intrinsics[view], scene.pose[view], mesh, tol=0.1, device=device
        )
        lvis = lin & vis_a & vis_b

        nl = scene.n_lines[view]
        det_l = scene.lines[view][:nl]
        det_l = det_l[det_l[:, 4] > score_threshold][:, :4]
        l_hits_this_view = 0
        if det_l.shape[0] and lvis.sum():
            d1 = np.linalg.norm(det_l[:, None, :2] - l2d[None, :, :2], axis=-1) + np.linalg.norm(
                det_l[:, None, 2:] - l2d[None, :, 2:], axis=-1
            )
            d2 = np.linalg.norm(det_l[:, None, :2] - l2d[None, :, 2:], axis=-1) + np.linalg.norm(
                det_l[:, None, 2:] - l2d[None, :, :2], axis=-1
            )
            ldist = np.minimum(d1, d2) * 0.5
            ri, ci = linear_sum_assignment(ldist)
            hit = (ldist[ri, ci] < match_threshold) & lvis[ci]
            line_hits[ci[hit]] += 1
            l_hits_this_view = int(hit.sum())
        l_rates.append(l_hits_this_view / max(int(lvis.sum()), 1))

        if verbose and view % 20 == 0:
            print(f"view {view}: junctions hit so far {(junction_hits > 0).sum()}"
                  f"/{junctions.shape[0]}, lines {(line_hits > 0).sum()}/{lines3d.shape[0]}")

    return {
        "junctions3d": junctions,
        "lines3d": lines3d,
        "junction_hits": junction_hits,
        "line_hits": line_hits,
        "junction_hit_rate_per_view": float(np.mean(j_rates)) if j_rates else 0.0,
        "line_hit_rate_per_view": float(np.mean(l_rates)) if l_rates else 0.0,
        "junctions_covered": int((junction_hits > 0).sum()),
        "lines_covered": int((line_hits > 0).sum()),
    }


def main(argv=None):
    from ..data.datasets import load_blender_scene

    parser = argparse.ArgumentParser(
        description="GT-wireframe detectability analysis (reference abc-analysis.py)"
    )
    parser.add_argument("--scan", type=str, required=True,
                        help="scan dir with images/cameras.npz/hawp/lines.json")
    parser.add_argument("--img-res", type=int, nargs=2, default=(512, 512))
    parser.add_argument("--mesh", type=str, default=None,
                        help="optional OBJ mesh for occlusion ray casting")
    parser.add_argument("--match-threshold", type=float, default=20.0)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the CPU")

    data_root = osp.dirname(osp.dirname(args.scan.rstrip("/")))
    data_dir = osp.relpath(args.scan.rstrip("/"), data_root)
    scene = load_blender_scene(
        data_dir, tuple(args.img_res), data_root=data_root, distance_threshold=1.0
    )
    res = analyze_detectability(
        scene, args.scan, mesh_path=args.mesh, match_threshold=args.match_threshold, device=args.device
    )
    print(
        f"junctions covered by detections: {res['junctions_covered']}"
        f"/{res['junctions3d'].shape[0]} "
        f"(mean per-view hit rate {res['junction_hit_rate_per_view']:.3f})"
    )
    print(
        f"lines covered by detections: {res['lines_covered']}"
        f"/{res['lines3d'].shape[0]} "
        f"(mean per-view hit rate {res['line_hit_rate_per_view']:.3f})"
    )
    # default to cwd, not the scan dir — data trees may be read-only
    out = args.out or f"wireframe_detectability_{osp.basename(args.scan.rstrip('/'))}.npz"
    # lines3d = the FULL GT line set, matching the reference artifact
    # (abc-analysis.py:182 filters with hit >= 0, i.e. keeps everything);
    # consumers slice by line_hits themselves
    np.savez(
        out,
        lines3d=res["lines3d"],
        junction_hits=res["junction_hits"],
        line_hits=res["line_hits"],
    )
    print(f"wrote {out}")
    return res


if __name__ == "__main__":
    main()
