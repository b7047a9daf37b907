"""Rendering evaluation: full-image PSNR per view + mesh export (port of
neat_tpu/evaluation/render_eval.py).

Parity target: reference code/evaluation/eval.py:97-166 — render every
pixel of every (or selected) view in chunks, write per-view PSNR rows and
mean±std to a csv, and export the marching surface of the SDF.

On a CUDA device a render chunk runs the f32 K1 and K3-fwd
(``model.neat.eval_kernel_config``) and the mesh grid the f32 K1; on the
CPU the plain versions. PNGs go through the package's own writer
(``data/png.py``).

    python -m neat_tpu_torch.evaluation.render_eval --conf <rundir>/runconf.conf \\
        --checkpoint latest --data_root <dir> [--views 0,3] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import Dict, Optional

import numpy as np
import torch

from ..data.png import write_png
from ..model.neat import NeatConfig, NeatModel, eval_kernel_config, neat_forward, offline_eval_config
from ..utils.chunking import merge_output, split_input
from ..viz.mesh import largest_component, save_ply, sdf_to_mesh


def render_view(
    model: NeatModel, cfg: NeatConfig, scene, view: int, chunksize: int = 1024, kernels: bool = True,
) -> Dict[str, np.ndarray]:
    """Render one full view in fixed-size chunks (reference eval.py's
    split_input/merge_output flow). ``kernels=False`` runs the plain
    versions on the card too."""
    dev = next(model.parameters()).device
    dt = next(model.parameters()).dtype
    cfg = eval_kernel_config(cfg, dev) if kernels else offline_eval_config(cfg)
    h, w = scene.img_res
    uv = scene.uv_full()
    n = uv.shape[0]
    as_t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    intr, pose = as_t(scene.intrinsics[view]), as_t(scene.pose[view])

    res = []
    for chunk in split_input({"uv": uv, "uv_proj": uv}, n, n_pixels=chunksize):
        inputs = {"uv": as_t(chunk["uv"]), "uv_proj": as_t(chunk["uv_proj"]), "intrinsics": intr, "pose": pose}
        with torch.no_grad():
            out = neat_forward(model, inputs, cfg, training=False)
        res.append({
            "rgb": out["rgb_values"].cpu().numpy(),
            "normal": out["normal_map"].cpu().numpy(),
            "depth": out["depth"].cpu().numpy(),
            "_valid": chunk["_valid"],
        })
    merged = merge_output(res, n)
    return {
        "rgb": merged["rgb"].reshape(h, w, 3),
        "normal": merged["normal"].reshape(h, w, 3),
        "depth": merged["depth"].reshape(h, w),
    }


def render_views_psnr(
    model: NeatModel,
    cfg: NeatConfig,
    scene,
    out_dir: Optional[str] = None,
    views: Optional[list] = None,
    chunksize: int = 1024,
    save_images: bool = True,
) -> Dict[str, float]:
    """Render views, compute PSNR vs GT, optionally write pngs + csv."""
    views = views if views is not None else list(range(scene.n_images))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    psnrs = []
    for view in views:
        out = render_view(model, cfg, scene, view, chunksize)
        gt = scene.rgb[view].reshape(*scene.img_res, 3)
        mse = float(np.mean((out["rgb"] - gt) ** 2))
        psnr = -10.0 * np.log(mse) / np.log(10.0)
        psnrs.append(psnr)
        if out_dir and save_images:
            write_png(osp.join(out_dir, f"eval_{view:03d}.png"),
                      (np.clip(out["rgb"], 0, 1) * 255).astype(np.uint8))
            write_png(osp.join(out_dir, f"normal_{view:03d}.png"),
                      (np.clip((out["normal"] + 1) / 2, 0, 1) * 255).astype(np.uint8))
    psnrs = np.asarray(psnrs)
    if out_dir:
        with open(osp.join(out_dir, "psnr.csv"), "w") as f:
            for v, p in zip(views, psnrs):
                f.write(f"{v},{p:.6f}\n")
            f.write(f"mean,{psnrs.mean():.6f}\nstd,{psnrs.std():.6f}\n")
    return {"psnr_mean": float(psnrs.mean()), "psnr_std": float(psnrs.std())}


def grid_sdf_fn(model: NeatModel, cfg: NeatConfig, kernels: bool = True):
    """host points (N, 3) -> clamped SDF (N,): the f32 K1 on the card
    (``fused_sdf_eval``) for the canonical SDF, the plain implicit SDF
    elsewhere or with ``kernels=False``."""
    from ..fields.mlp import implicit_sdf
    from ..ops.fused_sdf import fused_sdf_eval

    dev = next(model.parameters()).device
    dt = next(model.parameters()).dtype
    cfg = eval_kernel_config(cfg, dev) if kernels else offline_eval_config(cfg)

    @torch.no_grad()
    def sdf_fn(pts: np.ndarray) -> np.ndarray:
        p = torch.as_tensor(pts, dtype=dt, device=dev)
        if cfg.use_pallas_sampler:
            return fused_sdf_eval(model.implicit, p, cfg.implicit, "float32").cpu().numpy()
        return implicit_sdf(model.implicit, p, cfg.implicit)[..., 0].cpu().numpy()

    return sdf_fn


def export_scene_mesh(
    model: NeatModel,
    cfg: NeatConfig,
    path: str,
    resolution: int = 100,
    grid_boundary=(-1.5, 1.5),
    chunk: int = 65536,
    scale_mat=None,
    keep_largest_component: bool = False,
):
    """Marching surface of the SDF -> PLY (reference plots.py:140-218).
    ``chunk`` is the grid-evaluation batch.

    The DTU/BMVS eval protocol exports in WORLD coordinates with only the
    biggest connected component (reference eval.py:152-158) — pass the
    scene's scale_mat and keep_largest_component=True to match; the
    defaults keep the raw normalized-coordinate surface (debug/ABC use).
    Returns (verts, faces) as written."""
    verts, faces = sdf_to_mesh(
        grid_sdf_fn(model, cfg), resolution=resolution, grid_boundary=grid_boundary, chunk=chunk,
    )
    if scale_mat is not None:
        sm = np.asarray(scale_mat)
        verts = verts @ sm[:3, :3].T + sm[:3, 3]
    if keep_largest_component:
        verts, faces = largest_component(verts, faces)
    save_ply(path, verts, faces)
    return verts, faces


def main(argv=None):
    from ..data.datasets import load_scene_for_config
    from ..train.checkpoint import load_model
    from ..train.config import load_experiment_config
    from ..wireframe.finalize import unported_mesh

    parser = argparse.ArgumentParser(description="neat_tpu_torch render eval: per-view PSNR and the SDF mesh")
    parser.add_argument("--conf", type=str, required=True, help="runconf.conf path")
    parser.add_argument("--checkpoint", default="latest", type=str)
    parser.add_argument("--data_root", default="../data", type=str)
    parser.add_argument("--resolution", default=100, type=int)
    parser.add_argument("--chunksize", default=1024, type=int)
    parser.add_argument("--views", default=None, type=str, help="comma-separated ids")
    parser.add_argument("--mesh", default=0, type=int, dest="mesh_devices",
                        help="shard rendering over an N-device mesh (not ported: raises)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.mesh_devices:
        raise unported_mesh("--mesh")

    rundir = osp.dirname(args.conf)
    cfg = load_experiment_config(args.conf)
    model, epoch = load_model(osp.join(rundir, "checkpoints"), args.checkpoint, cfg.model, args.device)
    scene = load_scene_for_config(cfg, args.data_root)

    out_dir = osp.join(rundir, "evaluation")
    views = [int(v) for v in args.views.split(",")] if args.views else None
    stats = render_views_psnr(model, cfg.model, scene, out_dir, views, args.chunksize)
    print(f"PSNR {stats['psnr_mean']:.3f} +- {stats['psnr_std']:.3f}")
    # DTU/BMVS scenes (non-identity scale_mat) export in world coordinates
    # with only the biggest component (reference eval.py:152-158);
    # ABC/blender scenes keep normalized coords
    sm = np.asarray(scene.scale_mat)
    is_world = not np.allclose(sm, np.eye(4))
    path = osp.join(out_dir, f"surface_{epoch}.ply")
    export_scene_mesh(
        model, cfg.model, path,
        resolution=args.resolution,
        grid_boundary=cfg.grid_boundary,
        scale_mat=sm if is_world else None,
        keep_largest_component=is_world,
    )
    return {**stats, "mesh": path, "epoch": epoch}


if __name__ == "__main__":
    main()
