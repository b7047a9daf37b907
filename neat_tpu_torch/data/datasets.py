"""Scene loading for the ABC (blender), DTU / BlendedMVS and ScanNet
conventions (port of neat_tpu/data/datasets.py, numpy only).

A whole scene is packed into fixed-shape arrays (views x pixels) that
``train/step.py:scene_to_device`` moves to the device once; each step then
draws its rays there. A view's support-region pixel ids are padded to a
common length by wrapping, for uniform draws with replacement. Every packed
array equals the JAX package's bit for bit (tests/test_torch_data.py).

Ported kinds: ``blender``/``abc`` (cameras.npz{intrinsics, extrinsics}
with cam2world extrinsics, hawp/*.json wireframes), ``blender_plain`` (no
wireframes, every pixel trainable), ``dtu``/``scene``
(cameras.npz{world_mat_i, scale_mat_i}, P = world_mat @ scale_mat
decomposed into K and cam2world, optional depth cues), ``dtu_plain``,
``scannet`` (pose/*.txt cam2world, one shared 4x4 intrinsic.txt, optional
sparse depth_colmap/*.npy cues) and ``scene_line`` (a DTU scene with depth
cues from precomputed 3D lines, ``attach_line_depth_cues``).
"""

from __future__ import annotations

import dataclasses
import glob
import os.path as osp
import warnings
from typing import List, Optional, Tuple

import numpy as np

from ..core.camera import load_k_rt_from_p
from .bmp import read_bmp
from .encodels import attraction_support
from .jpeg import read_jpeg
from .png import read_png
from .wireframe import WireframeGraph


def _read_image(path: str) -> np.ndarray:
    """The samples of a PNG, BMP or JPEG file, as the JAX package's imageio
    read returns them; the files it cannot take raise, saying why."""
    if path.lower().endswith(".npy"):
        raise ValueError(
            f"{path}: an .npy image, which the JAX package's loader cannot read either (imageio has no "
            "backend for .npy; ROADMAP.md §3)"
        )
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic.startswith(b"\x89PNG"):
        return read_png(path)
    if magic.startswith(b"BM"):
        return read_bmp(path)
    if magic.startswith(b"\xff\xd8\xff"):
        return read_jpeg(path)
    raise ValueError(f"{path}: neither a PNG, a BMP nor a JPEG file")


def _load_rgb(path: str) -> np.ndarray:
    """Image as float32 [0, 1], (H, W, 3): 8-bit samples / 255, 16-bit ones
    / 65535, gray repeated to three channels, alpha dropped, a palette
    expanded. PNG, 24- or 32-bit uncompressed BMP and baseline JPEG
    (``data/jpeg.py``) are read; gray with alpha, .npy and the JPEG kinds
    the decoder does not take raise."""
    img = _read_image(path)
    if img.ndim == 3 and img.shape[-1] == 2:
        raise ValueError(
            f"{path}: gray with alpha: the JAX package's loader returns 2 channels here, which its scene "
            "loaders cannot pack into RGB (ROADMAP.md §3)"
        )
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    else:
        img = img.astype(np.float32) / 65535.0
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.shape[-1] == 4:
        img = img[..., :3]
    return img


def _glob_imgs(path: str) -> List[str]:
    imgs = []
    for ext in ("*.png", "*.jpg", "*.JPEG", "*.JPG", "*.bmp", "*.npy"):
        imgs.extend(glob.glob(osp.join(path, ext)))
    return sorted(imgs)


@dataclasses.dataclass
class SceneData:
    """A whole scene packed into fixed-shape numpy arrays.

    All per-pixel arrays are flattened row-major over (H, W); pixel index
    i corresponds to uv = (i % W, i // W) in (x, y) coordinates.
    """

    rgb: np.ndarray  # (V, H*W, 3) float32
    intrinsics: np.ndarray  # (V, 4, 4) float32
    pose: np.ndarray  # (V, 4, 4) float32 cam2world
    img_res: Tuple[int, int]  # (H, W)
    scale_mat: np.ndarray  # (4, 4)

    # wireframe supervision (None when with_wireframes=False)
    mask: Optional[np.ndarray] = None  # (V, H*W) bool
    labels: Optional[np.ndarray] = None  # (V, H*W) int32
    uv_proj: Optional[np.ndarray] = None  # (V, H*W, 2) float32
    lines: Optional[np.ndarray] = None  # (V, L_max, 5) float32 padded
    n_lines: Optional[np.ndarray] = None  # (V,) int32
    # the low-threshold (0.01) line set finalization matches against;
    # training supervises with 0.05
    lines_lo: Optional[np.ndarray] = None  # (V, L_lo_max, 5) float32 padded
    n_lines_lo: Optional[np.ndarray] = None  # (V,) int32
    verts2d: Optional[np.ndarray] = None  # (V, V_max, 2) float32 padded
    verts_mask: Optional[np.ndarray] = None  # (V, V_max) bool
    support_idx: Optional[np.ndarray] = None  # (V, S_max) int32
    support_count: Optional[np.ndarray] = None  # (V,) int32

    # per-pixel depth cues of the DTU loader's ``depth_dir``
    depth: Optional[np.ndarray] = None  # (V, H*W) float32

    view_ids: Optional[np.ndarray] = None  # original image indices kept

    @property
    def n_images(self) -> int:
        return self.rgb.shape[0]

    @property
    def total_pixels(self) -> int:
        return self.img_res[0] * self.img_res[1]

    def uv_full(self) -> np.ndarray:
        """(H*W, 2) full pixel grid in (x, y), matching the reference's
        flipped mgrid (blender_hawp_dataset.py:149-151)."""
        h, w = self.img_res
        ys, xs = np.mgrid[0:h, 0:w]
        return np.stack([xs, ys], axis=-1).reshape(-1, 2).astype(np.float32)


def _pack_lines(lines_list: List[np.ndarray]):
    """Pad a per-view list of (L_i, 5) line arrays to (V, L_max, 5)."""
    v = len(lines_list)
    l_max = max(max(ln.shape[0] for ln in lines_list), 1)
    out = np.zeros((v, l_max, 5), dtype=np.float32)
    counts = np.zeros((v,), dtype=np.int32)
    for i, ln in enumerate(lines_list):
        out[i, : ln.shape[0]] = ln
        counts[i] = ln.shape[0]
    return out, counts


def _pack_wireframes(
    wireframes: List[WireframeGraph],
    lines_list: List[np.ndarray],
    img_res: Tuple[int, int],
    distance_threshold: float,
    max_verts: Optional[int] = None,
    backend: str = "native",
):
    h, w = img_res
    v = len(wireframes)
    l_max = max(ln.shape[0] for ln in lines_list)
    v_max = max_verts or max(wf.num_vertices for wf in wireframes)

    lines = np.zeros((v, l_max, 5), dtype=np.float32)
    n_lines = np.zeros((v,), dtype=np.int32)
    verts2d = np.zeros((v, v_max, 2), dtype=np.float32)
    verts_mask = np.zeros((v, v_max), dtype=bool)
    masks = np.zeros((v, h * w), dtype=bool)
    labels = np.zeros((v, h * w), dtype=np.int32)
    uv_proj = np.zeros((v, h * w, 2), dtype=np.float32)

    for i, (wf, ln) in enumerate(zip(wireframes, lines_list)):
        n = ln.shape[0]
        lines[i, :n] = ln
        n_lines[i] = n
        if wf.num_vertices > v_max:
            warnings.warn(
                f"view {i}: {wf.num_vertices} wireframe vertices exceed "
                f"max_verts={v_max}; extra junction supervision is dropped "
                "(raise max_verts)"
            )
        nv = min(wf.num_vertices, v_max)
        verts2d[i, :nv] = wf.vertices[:nv]
        verts_mask[i, :nv] = True
        m, lab, proj = attraction_support(
            ln, h, w, distance_threshold=distance_threshold, backend=backend
        )
        masks[i] = m
        labels[i] = lab
        uv_proj[i] = proj

    # padded support-index table for device-side sampling
    counts = masks.sum(axis=1).astype(np.int32)
    s_max = int(max(counts.max(), 1))
    support_idx = np.zeros((v, s_max), dtype=np.int32)
    for i in range(v):
        idx = np.nonzero(masks[i])[0].astype(np.int32)
        if len(idx) == 0:
            idx = np.asarray([0], dtype=np.int32)
            counts[i] = 1
        support_idx[i, : len(idx)] = idx
        # pad by wrapping so any index read is valid
        if len(idx) < s_max:
            reps = -(-s_max // len(idx))
            support_idx[i] = np.tile(idx, reps)[:s_max]
    return lines, n_lines, verts2d, verts_mask, masks, labels, uv_proj, support_idx, counts


def _attach_wireframes(scene, wireframes, lines_list, distance_threshold, max_verts, backend) -> None:
    """Fill a scene's wireframe tables (``_pack_wireframes``) and its
    low-threshold line set."""
    (
        scene.lines,
        scene.n_lines,
        scene.verts2d,
        scene.verts_mask,
        scene.mask,
        scene.labels,
        scene.uv_proj,
        scene.support_idx,
        scene.support_count,
    ) = _pack_wireframes(wireframes, lines_list, scene.img_res, distance_threshold, max_verts, backend)
    scene.lines_lo, scene.n_lines_lo = _pack_lines([wf.line_segments(0.01) for wf in wireframes])


def load_blender_scene(
    data_dir: str,
    img_res: Tuple[int, int],
    data_root: str = "../data",
    reverse_coordinate: bool = False,  # accepted for conf parity; no-op
    line_detector: str = "hawp",
    distance_threshold: float = 10.0,
    score_threshold: float = 0.05,
    with_wireframes: bool = True,
    max_verts: Optional[int] = None,
    encodels_backend: str = "native",
) -> SceneData:
    """ABC-style scene: cameras.npz{intrinsics, extrinsics} + hawp json.
    Views whose wireframe has no vertex, no edge or no line above
    ``score_threshold`` are dropped."""
    del reverse_coordinate
    instance_dir = osp.join(data_root, data_dir)
    if not osp.exists(instance_dir):
        raise FileNotFoundError(f"Data directory {instance_dir} is empty")

    image_paths = [p for p in _glob_imgs(osp.join(instance_dir, "images")) if "mask" not in p]
    cam = np.load(osp.join(instance_dir, "cameras.npz"))
    intr_all = cam["intrinsics"].astype(np.float32)
    pose_all = cam["extrinsics"].astype(np.float32)

    rgbs, wireframes, lines_list, valid_ids = [], [], [], []
    for i, path in enumerate(image_paths):
        if with_wireframes:
            hawp_path = osp.join(
                instance_dir,
                line_detector,
                osp.splitext(osp.basename(path))[0] + ".json",
            )
            wf = WireframeGraph.load_json(hawp_path)
            if wf.num_vertices == 0 or wf.num_edges == 0:
                continue
            ln = wf.line_segments(score_threshold)
            if ln.shape[0] == 0:
                continue
            if (wf.frame_height, wf.frame_width) != tuple(img_res):
                raise ValueError(
                    f"{hawp_path}: wireframe frame {wf.frame_height} x {wf.frame_width}, conf img_res {img_res}"
                )
            wireframes.append(wf)
            lines_list.append(ln)
        img = _load_rgb(path)
        if img.shape[:2] != tuple(img_res):
            raise ValueError(f"{path}: image {img.shape} vs conf img_res {img_res}")
        rgbs.append(img.reshape(-1, 3))
        valid_ids.append(i)

    intr4 = np.tile(np.eye(4, dtype=np.float32), (len(valid_ids), 1, 1))
    intr4[:, :3, :3] = intr_all[valid_ids][:, :3, :3]

    scene = SceneData(
        rgb=np.stack(rgbs),
        intrinsics=intr4,
        pose=pose_all[valid_ids],
        img_res=tuple(img_res),
        scale_mat=np.eye(4, dtype=np.float32),
        view_ids=np.asarray(valid_ids, dtype=np.int32),
    )
    if with_wireframes:
        _attach_wireframes(scene, wireframes, lines_list, distance_threshold, max_verts, encodels_backend)
    return scene


def resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Nearest-neighbour resize of an (H, W[, C]) array to (h, w) by
    OpenCV's INTER_NEAREST rule (the card machine has no OpenCV): output
    row y reads source row min(floor(y * (1 / (h / H))), H - 1), in double
    precision as OpenCV computes it, and columns alike. That is
    floor(y * H / h) except where the double product falls just short of
    an integer (H = 6, h = 34, y = 17 reads row 2, not 3)."""
    src_h, src_w = img.shape[:2]
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / src_h))).astype(np.int64), src_h - 1)
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / src_w))).astype(np.int64), src_w - 1)
    return img[ys[:, None], xs[None, :]]


def _load_depth_maps(depth_dir: str, image_paths, valid_ids, img_res):
    """Per-view depth cues, (V, H*W) float32: <stem>.npy, <stem>_depth.npy
    or COLMAP's <stem>.{png,jpg}.geometric.bin, resized to ``img_res`` by
    ``resize_nearest`` where their size differs."""
    from ..colmap_tools.depth import read_array

    h, w = img_res
    out = []
    for i in valid_ids:
        stem = osp.splitext(osp.basename(image_paths[i]))[0]
        cand = [
            osp.join(depth_dir, stem + ".npy"),
            osp.join(depth_dir, stem + "_depth.npy"),
            osp.join(depth_dir, stem + ".png.geometric.bin"),
            osp.join(depth_dir, stem + ".jpg.geometric.bin"),
        ]
        path = next((p for p in cand if osp.exists(p)), None)
        if path is None:
            raise FileNotFoundError(f"no depth cue for {stem} in {depth_dir}")
        d = np.load(path) if path.endswith(".npy") else read_array(path)
        d = np.asarray(d, np.float32)
        if d.shape[:2] != (h, w):
            d = resize_nearest(d, h, w)
        out.append(d.reshape(-1))
    return np.stack(out)


def load_dtu_scene(
    data_dir: str,
    img_res: Tuple[int, int],
    scan_id: int = 0,
    data_root: str = "../data",
    line_detector: str = "hawp",
    distance_threshold: float = 10.0,
    score_threshold: float = 0.05,
    with_wireframes: bool = True,
    max_verts: Optional[int] = None,
    encodels_backend: str = "native",
    depth_dir: Optional[str] = None,
) -> SceneData:
    """DTU/BMVS-style scene ``<data_root>/<data_dir>/scan<scan_id>``:
    images in image/ (or images/), cameras.npz{world_mat_i, scale_mat_i}
    with P = world_mat @ scale_mat decomposed into K and cam2world, and
    hawp/*.json; a view with no wireframe file, or whose wireframe has no
    vertex, no edge or no line above ``score_threshold``, is dropped.
    ``depth_dir`` (relative to the scan directory, or absolute) adds the
    per-view depth cues."""
    instance_dir = osp.join(data_root, data_dir, f"scan{scan_id}")
    if not osp.exists(instance_dir):
        raise FileNotFoundError(f"Data directory {instance_dir} is empty")

    image_paths = _glob_imgs(osp.join(instance_dir, "image")) or _glob_imgs(osp.join(instance_dir, "images"))
    n_all = len(image_paths)
    cam = np.load(osp.join(instance_dir, "cameras.npz"))
    scale_mats = [cam[f"scale_mat_{i}"].astype(np.float64) for i in range(n_all)]
    world_mats = [cam[f"world_mat_{i}"].astype(np.float64) for i in range(n_all)]
    cams = [load_k_rt_from_p((wm @ sm)[:3, :4]) for sm, wm in zip(scale_mats, world_mats)]

    rgbs, wireframes, lines_list, valid_ids = [], [], [], []
    for i, path in enumerate(image_paths):
        if with_wireframes:
            hawp_path = osp.join(instance_dir, line_detector, osp.splitext(osp.basename(path))[0] + ".json")
            if not osp.exists(hawp_path):
                continue
            wf = WireframeGraph.load_json(hawp_path)
            if wf.num_vertices == 0 or wf.num_edges == 0:
                continue
            ln = wf.line_segments(score_threshold)
            if ln.shape[0] == 0:
                continue
            wireframes.append(wf)
            lines_list.append(ln)
        img = _load_rgb(path)
        if img.shape[:2] != tuple(img_res):
            raise ValueError(f"{path}: image {img.shape} vs conf img_res {img_res}")
        rgbs.append(img.reshape(-1, 3))
        valid_ids.append(i)

    scene = SceneData(
        rgb=np.stack(rgbs),
        intrinsics=np.stack([cams[i][0] for i in valid_ids]),
        pose=np.stack([cams[i][1] for i in valid_ids]),
        img_res=tuple(img_res),
        scale_mat=scale_mats[0].astype(np.float32),
        view_ids=np.asarray(valid_ids, dtype=np.int32),
    )
    if with_wireframes:
        _attach_wireframes(scene, wireframes, lines_list, distance_threshold, max_verts, encodels_backend)
    if depth_dir is not None:
        scene.depth = _load_depth_maps(
            osp.join(instance_dir, depth_dir), image_paths, valid_ids, tuple(img_res)
        )
    return scene


def load_scannet_scene(
    data_dir: str,
    img_res: Tuple[int, int],
    scan_id="",
    data_root: str = "../data",
    line_detector: str = "hawp",
    distance_threshold: float = 5.0,
    score_threshold: float = 0.05,
    with_wireframes: bool = True,
    max_verts: Optional[int] = None,
    encodels_backend: str = "native",
    depth_name: str = "depth_colmap",
) -> SceneData:
    """ScanNet-style scene ``<data_root>/<data_dir>[/<scan_id>]``: images in
    images/ (or color/), a cam2world pose/<stem>.txt per view, one 4x4
    intrinsic.txt (or intrinsic/intrinsic_color.txt, or intrinsics.txt)
    shared by every view, hawp/<stem>.json, and optional sparse depth cues
    ``<depth_name>/<stem>.npy`` with every depth above 2 m set to 0; a view
    without a cue file has none. A view with no wireframe file, or whose
    wireframe has no vertex, no edge or no line above ``score_threshold``,
    is dropped. ``scale_mat`` is the identity."""
    instance_dir = (
        osp.join(data_root, data_dir, str(scan_id))
        if scan_id not in (None, "")  # scan id 0 is a directory name
        else osp.join(data_root, data_dir)
    )
    if not osp.exists(instance_dir):
        raise FileNotFoundError(f"Data directory {instance_dir} is empty")
    image_paths = _glob_imgs(osp.join(instance_dir, "images")) or _glob_imgs(osp.join(instance_dir, "color"))

    intr_path = osp.join(instance_dir, "intrinsic.txt")
    if not osp.exists(intr_path):  # the other layouts ScanNet exports come in
        intr_path = osp.join(instance_dir, "intrinsic", "intrinsic_color.txt")
    if not osp.exists(intr_path):
        intr_path = osp.join(instance_dir, "intrinsics.txt")
    intr = np.loadtxt(intr_path).astype(np.float32).reshape(4, 4)

    h, w = img_res
    rgbs, poses, wireframes, lines_list, valid_ids, depths = [], [], [], [], [], []
    for i, path in enumerate(image_paths):
        stem = osp.splitext(osp.basename(path))[0]
        if with_wireframes:
            hawp_path = osp.join(instance_dir, line_detector, stem + ".json")
            if not osp.exists(hawp_path):
                continue
            wf = WireframeGraph.load_json(hawp_path)
            if wf.num_vertices == 0 or wf.num_edges == 0:
                continue
            ln = wf.line_segments(score_threshold)
            if ln.shape[0] == 0:
                continue
            wireframes.append(wf)
            lines_list.append(ln)
        poses.append(np.loadtxt(osp.join(instance_dir, "pose", stem + ".txt")).astype(np.float32).reshape(4, 4))
        img = _load_rgb(path)
        if img.shape[:2] != tuple(img_res):
            raise ValueError(f"{path}: image {img.shape} vs conf img_res {img_res}")
        rgbs.append(img.reshape(-1, 3))
        depth_path = osp.join(instance_dir, depth_name, stem + ".npy")
        if osp.exists(depth_path):
            d = np.load(depth_path).astype(np.float32).reshape(h * w)
            d[d > 2.0] = 0.0
        else:
            d = np.zeros(h * w, np.float32)
        depths.append(d)
        valid_ids.append(i)

    scene = SceneData(
        rgb=np.stack(rgbs),
        intrinsics=np.tile(intr[None], (len(rgbs), 1, 1)),
        pose=np.stack(poses),
        img_res=tuple(img_res),
        scale_mat=np.eye(4, dtype=np.float32),
        view_ids=np.asarray(valid_ids, dtype=np.int32),
    )
    if any(d.any() for d in depths):
        scene.depth = np.stack(depths)
    if with_wireframes:
        _attach_wireframes(scene, wireframes, lines_list, distance_threshold, max_verts, encodels_backend)
    return scene


def attach_line_depth_cues(
    scene: SceneData,
    lines_npz: str,
    n_points: int = 32,
    match_threshold: float = 10.0,
    score_threshold: float = 0.05,
) -> SceneData:
    """Depth cues from precomputed 3D lines (the ``lines3d`` array of an npz:
    (M, 2, 3), or an object array of such), per view: each detected 2D line
    above ``score_threshold`` is matched to the nearest projected 3D line
    (the smaller of the two endpoint orders' squared distances, below
    ``match_threshold``); ``n_points`` samples along each matched 3D
    segment in the camera frame write their camera-space depth at the
    rounded pixel they land on, the nearest sample winning where two land
    on one pixel. The cues fill ``scene.depth`` (0 where none); where the
    scene has depth already, the cues override it where they fall. In f64
    as the JAX package computes it."""
    raw = np.load(lines_npz, allow_pickle=True)["lines3d"]
    if raw.dtype == object:
        lines3d = np.concatenate([np.asarray(t) for t in raw], axis=0)
    else:
        lines3d = raw.reshape(-1, 2, 3)
    lines3d = lines3d.astype(np.float64)

    h, w = scene.img_res
    depth_maps = np.zeros((scene.n_images, h * w), dtype=np.float32)
    t = np.linspace(0.0, 1.0, n_points)[None, :, None]

    for view in range(scene.n_images):
        k3 = scene.intrinsics[view][:3, :3].astype(np.float64)
        w2c = np.linalg.inv(scene.pose[view].astype(np.float64))
        r, tr = w2c[:3, :3], w2c[:3, 3]

        cam_pts = lines3d.reshape(-1, 3) @ r.T + tr
        proj = cam_pts @ k3.T
        z = proj[:, 2:]
        z = np.where(np.abs(z) < 1e-8, 1e-8, z)
        l2d = (proj[:, :2] / z).reshape(-1, 4)

        det = scene.lines[view][: scene.n_lines[view]]
        det = det[det[:, 4] > score_threshold]
        if det.shape[0] == 0:
            continue
        d1 = ((l2d[:, None] - det[None, :, :4]) ** 2).sum(-1)
        d2 = ((l2d[:, None] - det[None, :, [2, 3, 0, 1]]) ** 2).sum(-1)
        dis = np.minimum(d1, d2)  # (3D lines, detected lines)
        mindis = dis.min(axis=0)
        minidx = dis.argmin(axis=0)
        avail = mindis < match_threshold
        if avail.sum() == 0:
            continue
        sel = lines3d[minidx[avail]]  # (M, 2, 3) world

        cam_lines = sel @ r.T + tr
        pts3d = (cam_lines[:, :1] * t + cam_lines[:, 1:] * (1.0 - t)).reshape(-1, 3)
        pts3d = pts3d[pts3d[:, 2] > 1e-6]
        if pts3d.shape[0] == 0:
            continue
        pix = pts3d @ k3.T
        uv = pix[:, :2] / pix[:, 2:]
        xi = np.round(uv[:, 0]).astype(np.int64)
        yi = np.round(uv[:, 1]).astype(np.int64)
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        flat = yi[ok] * w + xi[ok]
        depth = pts3d[ok, 2].astype(np.float32)
        # the nearest sample wins: written last, in the JAX package's order
        order = np.argsort(-depth)
        depth_maps[view][flat[order]] = depth[order]

    if scene.depth is not None:
        scene.depth = np.where(depth_maps > 0, depth_maps, scene.depth)
    else:
        scene.depth = depth_maps
    return scene


def load_scene_line_scene(
    lines_npz: str,
    depth_match_threshold: float = 10.0,
    depth_points_per_line: int = 32,
    **kwargs,
) -> SceneData:
    """A DTU-layout scene (``load_dtu_scene``'s keywords) with the depth
    cues of precomputed 3D lines (``attach_line_depth_cues``)."""
    if not lines_npz:
        raise ValueError(
            "scene_line datasets require dataset.lines_npz (a precomputed lines3d npz, e.g. a previous "
            "distillation or COLMAP line reconstruction) in the conf"
        )
    return attach_line_depth_cues(
        load_dtu_scene(**kwargs), lines_npz, n_points=depth_points_per_line, match_threshold=depth_match_threshold
    )


_LOADERS = {"blender": load_blender_scene, "abc": load_blender_scene, "dtu": load_dtu_scene,
            "scene": load_dtu_scene, "scene_line": load_scene_line_scene, "scannet": load_scannet_scene}


def load_scene(kind: str, **kwargs) -> SceneData:
    """Dispatch by convention name: 'blender'/'abc', 'dtu'/'scene',
    'scene_line', 'scannet'."""
    return _LOADERS[kind](**kwargs)


def _uniform_support(scene: SceneData) -> SceneData:
    """Replace the attraction-support sampling tables with full pixel
    coverage: training pixels drawn uniformly over the whole image."""
    v, hw = scene.n_images, scene.total_pixels
    return dataclasses.replace(
        scene,
        support_idx=np.tile(np.arange(hw, dtype=np.int32), (v, 1)),
        support_count=np.full((v,), hw, dtype=np.int32),
    )


def _plain_trainable(scene: SceneData) -> SceneData:
    """Make a wireframe-less scene trainable: full-coverage uniform pixel
    sampling plus inert wireframe tables (zero-score lines gate the line
    loss off; an empty verts mask empties the junction assignment), so the
    step's input set is the same as with wireframes."""
    v, hw = scene.n_images, scene.total_pixels
    h, w = scene.img_res
    uv = np.stack(
        [np.arange(hw, dtype=np.float32) % w,
         np.arange(hw, dtype=np.float32) // w], axis=-1
    )
    return dataclasses.replace(
        _uniform_support(scene),
        mask=np.ones((v, hw), dtype=bool),
        labels=np.zeros((v, hw), dtype=np.int32),
        uv_proj=np.tile(uv[None], (v, 1, 1)),
        lines=np.zeros((v, 1, 5), dtype=np.float32),
        n_lines=np.zeros((v,), dtype=np.int32),
        verts2d=np.zeros((v, 1, 2), dtype=np.float32),
        verts_mask=np.zeros((v, 1), dtype=bool),
    )


def load_scene_for_config(
    cfg,
    data_root: str,
    distance_threshold: Optional[float] = None,
    with_wireframes: Optional[bool] = None,
) -> SceneData:
    """Build the scene an ExperimentConfig describes. ``distance_threshold``
    overrides the conf value. A scene_line scene keeps its line tables but
    draws training pixels from the whole image."""
    kind = cfg.dataset_kind
    kwargs = dict(
        data_dir=cfg.data_dir,
        img_res=cfg.img_res,
        data_root=data_root,
        distance_threshold=(
            cfg.distance_threshold
            if distance_threshold is None
            else distance_threshold
        ),
        max_verts=cfg.model.max_verts,
        line_detector=cfg.line_detector,
    )
    if with_wireframes is not None:
        kwargs["with_wireframes"] = with_wireframes
    if kind in ("dtu", "scene"):
        return load_scene("dtu", scan_id=cfg.scan_id, depth_dir=cfg.depth_dir, **kwargs)
    if kind == "scene_line":
        # file depth loads first; the line cues override it where they fall
        scene = load_scene("scene_line", scan_id=cfg.scan_id, lines_npz=cfg.lines_npz, depth_dir=cfg.depth_dir,
                           **kwargs)
        return _uniform_support(scene)
    if kind == "scannet":
        return load_scene("scannet", scan_id=cfg.scan_id, **kwargs)
    if kind == "blender_plain":
        kwargs["with_wireframes"] = False
        return _plain_trainable(load_scene("blender", **kwargs))
    if kind == "dtu_plain":
        kwargs["with_wireframes"] = False
        return _plain_trainable(load_scene("dtu", scan_id=cfg.scan_id, **kwargs))
    return load_scene("blender", **kwargs)
