"""Synthetic wireframe scene generator (port of neat_tpu/data/synthetic.py,
numpy only; images written by ``data/png.py``).

Renders a colored wireframe solid from cameras on a sphere with a tiny
numpy z-buffer rasterizer and writes the full scene data contract:
images/, cameras.npz (intrinsics/extrinsics), hawp/*.json wireframes (the
projected visible edges) and lines.json CAD ground truth, so a scene can
be trained from disk with no data set at hand. For the DTU layout it can
also write depth cues and, with ``write_dtu_groundtruth``, the files the
DTU evaluation reads (the stl point cloud, ObsMask and Plane).
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Optional, Tuple

import numpy as np

from .png import write_png


_PALETTE = [
    (0.85, 0.3, 0.3), (0.3, 0.85, 0.3), (0.3, 0.3, 0.85),
    (0.85, 0.85, 0.3), (0.85, 0.3, 0.85), (0.3, 0.85, 0.85),
    (0.9, 0.55, 0.25), (0.55, 0.35, 0.8), (0.45, 0.7, 0.35),
    (0.7, 0.45, 0.45), (0.4, 0.55, 0.75), (0.75, 0.7, 0.5),
]


def _tris_from_quads(quads):
    """[(quad indices, color), ...] -> (faces (2Q, 3), colors (2Q, 3))."""
    faces, colors = [], []
    for q, c in quads:
        faces.append([q[0], q[1], q[2]])
        faces.append([q[0], q[2], q[3]])
        colors += [c, c]
    return np.asarray(faces), np.asarray(colors)


def _box(center, size):
    """Vertices (8, 3) and the 6 face quads (as index lists) of a cuboid."""
    cx, cy, cz = center
    sx, sy, sz = np.asarray(size) / 2.0
    verts = np.asarray(
        [
            [cx - sx, cy - sy, cz - sz], [cx + sx, cy - sy, cz - sz],
            [cx + sx, cy + sy, cz - sz], [cx - sx, cy + sy, cz - sz],
            [cx - sx, cy - sy, cz + sz], [cx + sx, cy - sy, cz + sz],
            [cx + sx, cy + sy, cz + sz], [cx - sx, cy + sy, cz + sz],
        ]
    )
    quads = [
        [0, 1, 2, 3], [4, 5, 6, 7], [0, 1, 5, 4],
        [2, 3, 7, 6], [1, 2, 6, 5], [0, 3, 7, 4],
    ]
    edges = [
        [0, 1], [1, 2], [2, 3], [3, 0],
        [4, 5], [5, 6], [6, 7], [7, 4],
        [0, 4], [1, 5], [2, 6], [3, 7],
    ]
    return verts, quads, edges


def cuboid_wireframe(size=(0.8, 0.5, 0.6)):
    """Vertices (8, 3), edges (12, 2), triangle faces (12, 3)."""
    verts, quads, edges = _box((0.0, 0.0, 0.0), size)
    faces, colors = _tris_from_quads(
        [(q, _PALETTE[i]) for i, q in enumerate(quads)]
    )
    return verts, np.asarray(edges), faces, colors


def bipyramid_wireframe(n_ring: int = 6, r: float = 0.55, h: float = 0.5):
    """HIGH-VALENCE family: a hexagonal bipyramid. The two apexes have
    junction valence ``n_ring`` (6), ring vertices valence 4 — stresses
    the junction vote gate and DBSCAN/merge eps far beyond the cuboid's
    uniform valence 3."""
    ring = np.asarray(
        [
            [r * np.cos(2 * np.pi * i / n_ring),
             r * np.sin(2 * np.pi * i / n_ring), 0.0]
            for i in range(n_ring)
        ]
    )
    verts = np.concatenate([ring, [[0.0, 0.0, h], [0.0, 0.0, -h]]])
    top, bot = n_ring, n_ring + 1
    edges, faces, colors = [], [], []
    for i in range(n_ring):
        j = (i + 1) % n_ring
        edges += [[i, j], [i, top], [i, bot]]
        faces += [[i, j, top], [j, i, bot]]
        colors += [_PALETTE[i % len(_PALETTE)],
                   _PALETTE[(i + 3) % len(_PALETTE)]]
    return verts, np.asarray(edges), np.asarray(faces), np.asarray(colors)


def slab_wireframe(size=(0.9, 0.6, 0.1)):
    """NEAR-PARALLEL family: a thin slab — its top and bottom rectangles
    form four close parallel line pairs separated by only ``size[2]``
    (0.1 normalized units), stressing junction/line separation and the
    merge eps (0.02 sits 5x under the pair gap)."""
    return cuboid_wireframe(size)


def stacked_wireframe():
    """T-JUNCTION / OCCLUSION family: a small cuboid centered on top of a
    larger one. The small cube's bottom rectangle lies INSIDE the big
    cube's top face (interior-of-face lines), its base corners are
    junctions that no big-cube edge touches, and the big cube occludes
    the notch region from below — the occlusion-heavy layout the
    single-cuboid scene never exercises."""
    v1, q1, e1 = _box((0.0, 0.0, -0.175), (0.9, 0.7, 0.35))
    v2, q2, e2 = _box((0.05, -0.05, 0.175), (0.4, 0.35, 0.35))
    verts = np.concatenate([v1, v2])
    edges = np.asarray(e1 + [[a + 8, b + 8] for a, b in e2])
    quads = [(q, _PALETTE[i]) for i, q in enumerate(q1)]
    # skip the small cube's bottom quad (q2[0]): it is interior, coplanar
    # with the big top face, and would z-fight; its EDGES stay — they are
    # the contact-rectangle lines the family exists to test
    quads += [([a + 8 for a in q], _PALETTE[(i + 6) % len(_PALETTE)])
              for i, q in enumerate(q2) if i != 0]
    faces, colors = _tris_from_quads(quads)
    return verts, edges, faces, colors


def grid_wireframe(size=(0.8, 0.8, 0.8)):
    """DENSE-SMALL-CELLS family: a cuboid whose every face is subdivided
    2x2 with checkerboard colors. The subdivision lines are real color
    edges in the images and real lines in the CAD ground truth; edge
    midpoints become collinear X/T-junctions (valence 4) and face centers
    valence-4 crossings, 0.4 units apart — the dense-cell regime."""
    sx, sy, sz = np.asarray(size) / 2.0

    vid = {}
    verts = []

    def v(x, y, z):
        key = (round(x, 6), round(y, 6), round(z, 6))
        if key not in vid:
            vid[key] = len(verts)
            verts.append([x, y, z])
        return vid[key]

    edges = set()
    quads = []
    # each face: constant-axis plane, 2x2 subdivision in the other two
    face_specs = [
        (0, -sx), (0, sx), (1, -sy), (1, sy), (2, -sz), (2, sz),
    ]
    half = {0: (sy, sz), 1: (sx, sz), 2: (sx, sy)}
    for fi, (axis, val) in enumerate(face_specs):
        h1, h2 = half[axis]
        u_lines = [-h1, 0.0, h1]
        v_lines = [-h2, 0.0, h2]
        for i in range(2):
            for j in range(2):
                corners2d = [
                    (u_lines[i], v_lines[j]), (u_lines[i + 1], v_lines[j]),
                    (u_lines[i + 1], v_lines[j + 1]), (u_lines[i], v_lines[j + 1]),
                ]
                ids = []
                for (a, b) in corners2d:
                    coord = [0.0, 0.0, 0.0]
                    coord[axis] = val
                    coord[(axis + 1) % 3] = a
                    coord[(axis + 2) % 3] = b
                    ids.append(v(*coord))
                for t in range(4):
                    e = (min(ids[t], ids[(t + 1) % 4]), max(ids[t], ids[(t + 1) % 4]))
                    edges.add(e)
                color = _PALETTE[(fi * 2 + ((i + j) % 2)) % len(_PALETTE)]
                quads.append((ids, color))
    faces, colors = _tris_from_quads(quads)
    return (
        np.asarray(verts),
        np.asarray(sorted(edges)),
        faces,
        colors,
    )


def tetra_wireframe(scale: float = 0.75):
    """SPARSE-LARGE-FRAME family: a tetrahedron — 4 junctions, 6 long
    lines, the minimal-support end of the spectrum (every junction must
    be recovered from only 3 incident lines)."""
    verts = scale * np.asarray(
        [
            [1.0, 1.0, 1.0], [1.0, -1.0, -1.0],
            [-1.0, 1.0, -1.0], [-1.0, -1.0, 1.0],
        ]
    ) / np.sqrt(3)
    edges = np.asarray(
        [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]]
    )
    faces = np.asarray([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]])
    colors = np.asarray(_PALETTE[:4])
    return verts, edges, faces, colors


GEOMETRIES = {
    "cuboid": cuboid_wireframe,
    "bipyramid": bipyramid_wireframe,
    "slab": slab_wireframe,
    "stacked": stacked_wireframe,
    "grid": grid_wireframe,
    "tetra": tetra_wireframe,
}


def look_at_pose(cam_pos: np.ndarray, target=np.zeros(3), up=(0.0, 0.0, 1.0)):
    """cam2world with +z forward (OpenCV), +y down-ish."""
    fwd = target - cam_pos
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, float))
    if np.linalg.norm(right) < 1e-6:
        right = np.cross(fwd, np.asarray([0.0, 1.0, 0.0]))
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    pose = np.eye(4)
    pose[:3, 0] = right
    pose[:3, 1] = down
    pose[:3, 2] = fwd
    pose[:3, 3] = cam_pos
    return pose


def render_view(verts, faces, colors, k, pose, res: Tuple[int, int]):
    """Tiny z-buffer triangle rasterizer. Returns (rgb (H,W,3), depth)."""
    h, w = res
    w2c = np.linalg.inv(pose)
    cam = (w2c[:3, :3] @ verts.T + w2c[:3, 3:]).T
    proj = (k @ cam.T).T
    uv = proj[:, :2] / proj[:, 2:]
    z = cam[:, 2]

    img = np.full((h, w, 3), 1.0, dtype=np.float32)  # white background
    zbuf = np.full((h, w), np.inf, dtype=np.float32)
    for f_idx, tri in enumerate(faces):
        p = uv[tri]
        tz = z[tri]
        if (tz <= 0.05).any():
            continue
        lo = np.maximum(np.floor(p.min(0)).astype(int), 0)
        hi = np.minimum(np.ceil(p.max(0)).astype(int) + 1, [w, h])
        if (hi <= lo).any():
            continue
        xs, ys = np.meshgrid(np.arange(lo[0], hi[0]), np.arange(lo[1], hi[1]))
        pix = np.stack([xs, ys], axis=-1).reshape(-1, 2).astype(np.float64)
        # barycentric
        v0, v1, v2 = p[0], p[1], p[2]
        d = (v1[1] - v2[1]) * (v0[0] - v2[0]) + (v2[0] - v1[0]) * (v0[1] - v2[1])
        if abs(d) < 1e-9:
            continue
        l0 = ((v1[1] - v2[1]) * (pix[:, 0] - v2[0]) + (v2[0] - v1[0]) * (pix[:, 1] - v2[1])) / d
        l1 = ((v2[1] - v0[1]) * (pix[:, 0] - v2[0]) + (v0[0] - v2[0]) * (pix[:, 1] - v2[1])) / d
        l2 = 1 - l0 - l1
        inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0)
        if not inside.any():
            continue
        pix_in = pix[inside].astype(int)
        # perspective-correct depth via 1/z interpolation
        zi = 1.0 / (l0[inside] / tz[0] + l1[inside] / tz[1] + l2[inside] / tz[2])
        better = zi < zbuf[pix_in[:, 1], pix_in[:, 0]]
        pi = pix_in[better]
        zbuf[pi[:, 1], pi[:, 0]] = zi[better]
        # simple shading by depth for texture
        shade = 1.0 - 0.15 * ((zi[better] - zi.min()) / max(float(np.ptp(zi)), 1e-6))
        img[pi[:, 1], pi[:, 0]] = colors[f_idx][None] * shade[:, None]
    return img, zbuf


def visible_edges(verts, edges, k, pose, zbuf, res, n_samples: int = 24):
    """Project edges; an edge is kept if most of its samples are depth-
    visible (the synthetic HAWP detector)."""
    h, w = res
    w2c = np.linalg.inv(pose)
    cam = (w2c[:3, :3] @ verts.T + w2c[:3, 3:]).T
    proj = (k @ cam.T).T
    uv = proj[:, :2] / proj[:, 2:]
    z = cam[:, 2]

    out_edges, weights = [], []
    for e in edges:
        t = np.linspace(0.05, 0.95, n_samples)
        pts = uv[e[0]][None] * (1 - t[:, None]) + uv[e[1]][None] * t[:, None]
        zs = 1.0 / ((1 - t) / z[e[0]] + t / z[e[1]])
        xi = np.clip(pts[:, 0].round().astype(int), 0, w - 1)
        yi = np.clip(pts[:, 1].round().astype(int), 0, h - 1)
        vis = zs <= zbuf[yi, xi] + 2e-2
        frac = vis.mean()
        if frac > 0.5:
            out_edges.append(e)
            weights.append(float(frac))
    return np.asarray(out_edges).reshape(-1, 2), np.asarray(weights)


def generate_scene(
    out_dir: str,
    n_views: int = 12,
    res: Tuple[int, int] = (96, 96),
    radius: float = 2.0,
    seed: int = 0,
    convention: str = "blender",
    geometry: str = "cuboid",
    scale_mat: Optional[np.ndarray] = None,
    depth_dir: Optional[str] = None,
) -> None:
    """Write a full synthetic scene in either data convention.

    convention='blender': images/, cameras.npz{intrinsics, extrinsics},
    hawp/, lines.json (ABC layout). convention='dtu': image/,
    cameras.npz{world_mat_i, scale_mat_i} with world_mat = K [R|t] and an
    identity scale_mat, hawp/, lines.json (DTU/BMVS layout).
    convention='scannet': images/, pose/*.txt (cam2world), a shared
    intrinsic.txt, hawp/, lines.json (ScanNet layout).

    geometry: one of GEOMETRIES — structurally distinct wireframe
    families (valence, parallelism, occlusion, cell density, sparsity).

    scale_mat (dtu only): the 4x4 map from the frame the scene is rendered
    in to a ground-truth frame, written as every view's scale_mat_i with
    world_mat_i = K [R|t] scale_mat^-1, so that P = world_mat @ scale_mat
    is the camera DTU's loader decomposes (identity when None).
    depth_dir: also write each view's depth cue, the distance along the
    pixel's ray to the first surface (0 where the ray hits nothing), as
    <out_dir>/<depth_dir>/<image stem>.npy.
    """
    img_dir = "image" if convention == "dtu" else "images"
    os.makedirs(osp.join(out_dir, img_dir), exist_ok=True)
    os.makedirs(osp.join(out_dir, "hawp"), exist_ok=True)
    if convention == "scannet":
        os.makedirs(osp.join(out_dir, "pose"), exist_ok=True)
    if depth_dir is not None:
        os.makedirs(osp.join(out_dir, depth_dir), exist_ok=True)

    verts, edges, faces, colors = GEOMETRIES[geometry]()
    h, w = res
    focal = 1.2 * max(res)
    k = np.asarray(
        [[focal, 0, w / 2.0], [0, focal, h / 2.0], [0, 0, 1.0]]
    )

    rs = np.random.RandomState(seed)
    intr_all, pose_all = [], []
    golden = np.pi * (3.0 - np.sqrt(5.0))
    for i in range(n_views):
        # Fibonacci-sphere coverage: golden-angle azimuth with z
        # stratified over the full sphere, as the ABC toy scene's cameras
        # span elevations on both sides of the equator. Golden-angle
        # azimuth keeps azimuth and elevation uncorrelated, so views such
        # as "+y side and above the scene" occur. |z| capped at 0.93 keeps
        # look_at_pose's up=(0,0,1) well-conditioned.
        theta = golden * i + rs.rand() * 0.2
        zfrac = -0.93 + 1.86 * (i + rs.rand()) / n_views
        zfrac = float(np.clip(zfrac, -0.93, 0.93))
        phi = np.arccos(zfrac)
        cam_pos = radius * np.asarray(
            [np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)]
        )
        pose = look_at_pose(cam_pos)
        img, zbuf = render_view(verts, faces, colors, k, pose, res)
        write_png(
            osp.join(out_dir, img_dir, f"image_{i:04d}.png"),
            (np.clip(img, 0, 1) * 255).astype(np.uint8),
        )
        ve, vw = visible_edges(verts, edges, k, pose, zbuf, res)
        w2c = np.linalg.inv(pose)
        cam = (w2c[:3, :3] @ verts.T + w2c[:3, 3:]).T
        proj = (k @ cam.T).T
        uv = proj[:, :2] / proj[:, 2:]
        wf = {
            "vertices": uv.tolist(),
            "vertices-score": [1.0] * len(uv),
            "edges": ve.tolist(),
            "edges-weights": vw.tolist(),
            "height": h,
            "width": w,
        }
        with open(osp.join(out_dir, "hawp", f"image_{i:04d}.json"), "w") as f:
            json.dump(wf, f)
        if depth_dir is not None:
            ys, xs = np.mgrid[0:h, 0:w]
            rays = np.linalg.solve(k, np.stack([xs, ys, np.ones_like(xs)], axis=0).reshape(3, -1))
            dist = zbuf * np.linalg.norm(rays, axis=0).reshape(h, w)
            np.save(osp.join(out_dir, depth_dir, f"image_{i:04d}.npy"),
                    np.where(np.isfinite(zbuf), dist, 0.0).astype(np.float32))
        intr_all.append(k)
        pose_all.append(pose)

    if convention == "blender":
        np.savez(
            osp.join(out_dir, "cameras.npz"),
            intrinsics=np.stack(intr_all).astype(np.float32),
            extrinsics=np.stack(pose_all).astype(np.float32),
        )
    elif convention == "scannet":
        k4 = np.eye(4)
        k4[:3, :3] = intr_all[0]
        np.savetxt(osp.join(out_dir, "intrinsic.txt"), k4)
        for i, pose in enumerate(pose_all):
            np.savetxt(osp.join(out_dir, "pose", f"image_{i:04d}.txt"), pose)
    else:
        sm = np.eye(4) if scale_mat is None else np.asarray(scale_mat, np.float64)
        cams = {}
        for i, (ki, pose) in enumerate(zip(intr_all, pose_all)):
            w2c = np.linalg.inv(pose)
            p = np.eye(4)
            p[:3] = ki @ w2c[:3]
            cams[f"world_mat_{i}"] = p if scale_mat is None else p @ np.linalg.inv(sm)
            cams[f"scale_mat_{i}"] = sm
        np.savez(osp.join(out_dir, "cameras.npz"), **cams)
    with open(osp.join(out_dir, "lines.json"), "w") as f:
        json.dump({"junctions": verts.tolist(), "lines": edges.tolist()}, f)
    # the synthetic scene trains directly in the GT frame: identity mapping
    with open(osp.join(out_dir, "offset_scale.txt"), "w") as f:
        f.write("0 0 0 1\n")


def write_dtu_groundtruth(
    eval_dir: str,
    scan: int,
    scale_mat: np.ndarray,
    geometry: str = "cuboid",
    n_points: int = 20000,
    res: float = 10.0,
    seed: int = 0,
) -> None:
    """The DTU evaluation's ground truth for a scene ``generate_scene``
    wrote with ``scale_mat``, in the ground-truth frame:
    Points/stl/stl{scan:03}_total.ply (``n_points`` samples of the
    geometry's surface), ObsMask/ObsMask{scan}_10.mat (ObsMask: every cell
    of a grid of ``res`` spacing over the surface's box, 3 cells of margin,
    observed; BB; Res) and ObsMask/Plane{scan}.mat (P: a ground plane one
    cell below the surface, every stl point above it)."""
    from scipy.io import savemat

    from ..viz.mesh import sample_mesh_surface, save_ply

    verts, _, faces, _ = GEOMETRIES[geometry]()
    sm = np.asarray(scale_mat, np.float64)
    pts = sample_mesh_surface(verts, faces, n_points, seed=seed)
    pts = pts @ sm[:3, :3].T + sm[:3, 3]
    os.makedirs(osp.join(eval_dir, "Points", "stl"), exist_ok=True)
    os.makedirs(osp.join(eval_dir, "ObsMask"), exist_ok=True)
    save_ply(osp.join(eval_dir, "Points", "stl", f"stl{scan:03}_total.ply"), pts)
    bb = np.stack([pts.min(0) - 3 * res, pts.max(0) + 3 * res])
    shape = tuple(int(v) for v in np.ceil((bb[1] - bb[0]) / res) + 1)
    savemat(osp.join(eval_dir, "ObsMask", f"ObsMask{scan}_10.mat"),
            {"ObsMask": np.ones(shape, dtype=np.uint8), "BB": bb, "Res": np.asarray([[res]])})
    savemat(osp.join(eval_dir, "ObsMask", f"Plane{scan}.mat"),
            {"P": np.asarray([[0.0], [0.0], [1.0], [-(pts[:, 2].min() - res)]])})


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description="synthetic wireframe scene")
    parser.add_argument("--out", required=True)
    parser.add_argument("--views", type=int, default=12)
    parser.add_argument("--res", type=int, default=96)
    parser.add_argument("--geometry", default="cuboid",
                        choices=sorted(GEOMETRIES))
    args = parser.parse_args()
    generate_scene(
        args.out, n_views=args.views, res=(args.res, args.res),
        geometry=args.geometry,
    )
    print(f"wrote synthetic {args.geometry} scene to {args.out}")
