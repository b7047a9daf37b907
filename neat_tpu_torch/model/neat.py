"""The NEAT model: VolSDF surface + attraction field + global junctions
(port of neat_tpu/model/neat.py, default ``neat`` variant).

``neat_forward`` is one training-mode (or eval-mode) forward pass with the
same outputs, detach boundaries and padding masks as the JAX function.
Random draws come from a ``noise`` dict (``draw_forward_noise``), so a test
can feed both packages the same numbers.

The kernel flags keep their JAX names: ``use_pallas_sampler`` routes the
sampler's proposal SDF through the hand-written CUDA kernel K1
(``ops/fused_sdf.py``); ``use_pallas_field`` routes the main field pass
through K2-fwd / K2-bwd (``pallas_field_backward = 'stash'``,
``ops/fused_field_stash.py``) or K3-fwd / K3-bwd (``'recompute'``,
``ops/fused_field.py``); ``sampler.fused_rounds = 'on'`` runs the sampler's
rounds through K4 (``ops/fused_round.py``). On CPU tensors those wrappers
run their plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..assignment.clustering import dbscan_cluster_means
from ..assignment.matching import masked_assignment
from ..core.camera import get_camera_params, project2d
from ..core.density import LaplaceDensity, laplace_density
from ..core.render import render_weights_from_density
from ..fields.mlp import (
    GlobalJunctionsConfig,
    ImplicitNetConfig,
    RenderNetConfig,
    attraction_forward,
    global_junctions_forward,
    implicit_gradient,
    implicit_sdf,
    implicit_sdf_feat_grad,
    init_attraction_net,
    init_global_junctions,
    init_implicit_net,
    init_render_net,
    render_forward,
)
from ..sampling.samplers import (
    ErrorBoundSamplerConfig,
    error_bound_z_vals,
    total_final_samples,
    total_proposal_samples,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class NeatConfig:
    """Field for field the JAX ``NeatConfig``. In this package the kernel
    flags select the hand-written CUDA kernels: ``use_pallas_sampler`` ->
    K1, ``use_pallas_field`` -> K2 (``pallas_field_backward='stash'``) or
    K3 (``'recompute'``).
    Only the default ``neat`` variant is ported, with or without DBSCAN
    junction proposals (``dbscan_enabled``); other variant flags raise
    ``NotImplementedError`` (ROADMAP.md §1, variants)."""

    feature_vector_size: int = 256
    scene_bounding_sphere: float = 3.0
    white_bkgd: bool = False
    bg_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)

    implicit: ImplicitNetConfig = ImplicitNetConfig()
    rendering: RenderNetConfig = RenderNetConfig(multires_view=4)
    attraction: RenderNetConfig = RenderNetConfig(d_out=6, multires_view=0)
    junctions: GlobalJunctionsConfig = GlobalJunctionsConfig()
    sampler: ErrorBoundSamplerConfig = ErrorBoundSamplerConfig()

    density_beta_init: float = 0.1
    density_beta_min: float = 1e-4

    model_variant: str = "neat"
    sampler_kind: str = "error_bound"
    detach_line_weights: bool = True
    attraction_at_surface: bool = False
    eval_attraction_at_l3d: bool = False
    attraction_aggregation: str = "weighted"
    endpoint_sdf_separate: bool = False
    detach_lines2d: bool = True
    dual_batch: bool = False
    dbscan_enabled: bool = False
    dbscan_include_global: bool = False
    use_median: bool = True
    use_l3d: bool = False
    junction_eikonal: bool = False

    max_verts: int = 512
    assignment_method: str = "auction"
    # precision of the sampler's proposal SDF evals; with use_pallas_sampler
    # it is K1's compute dtype (the JAX kernel is always bf16, the default)
    sampler_compute_dtype: str = "bfloat16"
    field_compute_dtype: str = "float32"
    use_pallas_sampler: bool = False
    use_pallas_field: bool = False
    pallas_field_backward: str = "recompute"

    @staticmethod
    def for_abc() -> "NeatConfig":
        """Defaults of confs/abc-neat-a.conf."""
        return NeatConfig(
            junctions=GlobalJunctionsConfig(num_junctions=64),
            dbscan_enabled=False,
            use_l3d=False,
            use_median=True,
        )

    @staticmethod
    def for_dtu() -> "NeatConfig":
        """Defaults of confs/dtu.conf."""
        return NeatConfig(
            scene_bounding_sphere=3.0,
            implicit=ImplicitNetConfig(bias=0.6, sphere_scale=20.0),
            junctions=GlobalJunctionsConfig(num_junctions=1024),
            dbscan_enabled=True,
            # dtu.conf: a fixed 10 px assignment gate, not the step's median
            use_median=False,
        )


def offline_eval_config(cfg: NeatConfig) -> NeatConfig:
    """Exact-f32 variant for offline rendering / finalization: the same
    fields as the JAX function sets (f32 sampler and field, both kernel
    flags off), so a CPU run holds the meaning it has in the reference.

    The JAX package turns its kernels off here because its K1 computes in
    bf16 only, which shows as banding in full-image renders. This port has
    f32 kernels for both functions the eval forward spends its time in (K1
    f32, ``ops/fused_sdf.py``; K3-fwd f32, ``ops/fused_field.py``), so
    ``eval_kernel_config`` turns the flags back on, still in f32, on the
    card. On CPU tensors those wrappers run their plain versions."""
    return dataclasses.replace(
        cfg,
        sampler_compute_dtype="float32",
        field_compute_dtype="float32",
        use_pallas_sampler=False,
        use_pallas_field=False,
    )


def eval_kernel_config(cfg: NeatConfig, device) -> NeatConfig:
    """``offline_eval_config`` with the f32 K1 and K3-fwd switched on where
    ``device`` is a CUDA device and the architecture is the one the kernels
    are written for (``supports_fused_sdf``, ``supports_fused_field``).
    Elsewhere it is ``offline_eval_config``: the plain versions."""
    from ..ops.fused_field import supports_fused_field
    from ..ops.fused_sdf import supports_fused_sdf

    cfg = offline_eval_config(cfg)
    if torch.device(device).type != "cuda":
        return cfg
    return dataclasses.replace(
        cfg,
        use_pallas_sampler=supports_fused_sdf(cfg.implicit),
        use_pallas_field=supports_fused_field(cfg.implicit, cfg.rendering, cfg.attraction),
        pallas_field_backward="recompute",
    )


_UNPORTED = {
    "model_variant": "neat",
    "sampler_kind": "error_bound",
    "attraction_at_surface": False,
    "eval_attraction_at_l3d": False,
    "attraction_aggregation": "weighted",
    "endpoint_sdf_separate": False,
    "dual_batch": False,
    "dbscan_include_global": False,
    "junction_eikonal": False,
}


def check_ported(cfg: NeatConfig) -> None:
    """Raise for a variant flag this slice does not port."""
    for name, default in _UNPORTED.items():
        if getattr(cfg, name) != default:
            raise NotImplementedError(
                f"NeatConfig.{name}={getattr(cfg, name)!r} is not ported yet "
                "(ROADMAP.md §1, variants); only the default neat variant runs"
            )
    if cfg.pallas_field_backward not in ("stash", "recompute"):
        raise ValueError(
            f"pallas_field_backward is 'stash' or 'recompute', got {cfg.pallas_field_backward!r}"
        )


class NeatModel(nn.Module):
    """Parameter container: implicit, rendering, attraction (layer stacks
    of lin0..), density (beta) and junctions (latents + ffn)."""

    def __init__(self, implicit, rendering, attraction, density, junctions):
        super().__init__()
        self.implicit = implicit
        self.rendering = rendering
        self.attraction = attraction
        self.density = density
        self.junctions = junctions


def init_neat(cfg: NeatConfig, seed: int = 0, device="cuda") -> NeatModel:
    """Random weights from ``seed`` (drawn on the CPU, so every device gets
    the same ones), moved to ``device``."""
    check_ported(cfg)
    gen = torch.Generator().manual_seed(seed)
    model = NeatModel(
        implicit=init_implicit_net(gen, cfg.implicit),
        rendering=init_render_net(gen, cfg.rendering),
        attraction=init_attraction_net(gen, cfg.attraction),
        density=LaplaceDensity(cfg.density_beta_init),
        junctions=init_global_junctions(gen, cfg.junctions),
    )
    return model.to(device)


def draw_forward_noise(gen: torch.Generator, n_rays: int, cfg: NeatConfig, device="cuda"):
    """Every random array a training-mode ``neat_forward`` consumes: per-ray
    eik_uniform, strat, final_u, eik_z_idx; ray-shared z_extra_idx."""
    s = cfg.sampler
    bs = cfg.scene_bounding_sphere
    kw = dict(generator=gen, device=device)
    noise = {
        "eik_uniform": torch.rand((n_rays, 3), **kw) * (2 * bs) - bs,
        "strat": torch.rand((n_rays, s.n_samples_eval), **kw),
        "final_u": torch.rand((n_rays, s.n_samples), **kw),
        "eik_z_idx": torch.randint(0, total_final_samples(s), (n_rays, 1), **kw),
    }
    if s.n_samples_extra > 0:
        perm = torch.randperm(total_proposal_samples(s), **kw)
        noise["z_extra_idx"] = perm[: s.n_samples_extra]
    return noise


def _masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """torch-style lower median over the masked entries; 10 when none."""
    big = torch.full_like(values, 1e30)
    order = torch.sort(torch.where(mask, values, big)).values
    n_valid = torch.sum(mask)
    idx = torch.clamp(torch.div(n_valid - 1, 2, rounding_mode="floor"), min=0)
    med = order[idx]
    return torch.where(n_valid > 0, med, torch.full_like(med, 10.0))


def _sample_z(ray_dirs, cam_loc, model, cfg: NeatConfig, training, noise):
    cd = _DTYPES[cfg.sampler_compute_dtype]
    if cfg.use_pallas_sampler:
        from ..ops.fused_sdf import fused_sdf_eval

        sdf_fn = lambda p: fused_sdf_eval(model.implicit, p, cfg.implicit, cfg.sampler_compute_dtype)
    else:
        cdtype = cd if cd != torch.float32 else None
        sdf_fn = lambda p: implicit_sdf(model.implicit, p, cfg.implicit, compute_dtype=cdtype)[..., 0]
    return error_bound_z_vals(
        ray_dirs, cam_loc, sdf_fn, model.density, cfg.sampler, training,
        beta_min=cfg.density_beta_min, noise=noise,
    )


def neat_forward(
    model: NeatModel,
    inputs: Dict[str, torch.Tensor],
    cfg: NeatConfig,
    gen: Optional[torch.Generator] = None,
    training: bool = True,
    noise: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Full NEAT forward pass.

    inputs: uv (R, 2), uv_proj (R, 2), intrinsics (4, 4), pose (4, 4),
    verts2d (V, 2) and verts_mask (V,) (training only). In training mode
    the random draws come from ``noise`` or, when it is None, from
    ``draw_forward_noise(gen, ...)``.
    """
    check_ported(cfg)
    uv, pose, intrinsics = inputs["uv"], inputs["pose"], inputs["intrinsics"]
    n_rays = uv.shape[0]
    if training and noise is None:
        noise = draw_forward_noise(gen, n_rays, cfg, device=uv.device)

    ray_dirs, cam_loc = get_camera_params(uv[None], pose[None], intrinsics[None])
    ray_dirs = ray_dirs[0]
    cam_loc = cam_loc.expand(n_rays, 3)

    z_vals, z_eik = _sample_z(ray_dirs, cam_loc, model, cfg, training, noise)
    n_samples = z_vals.shape[-1]

    rays_d = z_vals[..., None] * ray_dirs[:, None, :]
    depth_ratio = torch.linalg.norm(rays_d, dim=-1)
    points = cam_loc[:, None, :] + rays_d
    points_flat = points.reshape(-1, 3)
    dirs_flat = ray_dirs[:, None, :].expand(points.shape).reshape(-1, 3)

    fdtype = _DTYPES[cfg.field_compute_dtype]
    fdtype = None if fdtype == torch.float32 else fdtype
    if cfg.use_pallas_field:
        from ..ops.fused_field import fused_field_eval, supports_field_math
        from ..ops.fused_field_stash import fused_field_eval_stash

        if not supports_field_math(cfg.implicit, cfg.rendering, cfg.attraction):
            raise ValueError(
                "use_pallas_field=True needs the 9-layer skip-4 SDF and 5-layer "
                "idr heads the fused field math implements"
            )
        field_eval = (
            fused_field_eval_stash if cfg.pallas_field_backward == "stash" else fused_field_eval
        )
        sdf, grads, rgb_flat, lines3d_flat = field_eval(
            model, points_flat, dirs_flat, cfg.implicit, cfg.rendering,
            compute_dtype=cfg.field_compute_dtype, acfg=cfg.attraction,
        )
    else:
        sdf, feats, grads = implicit_sdf_feat_grad(
            model.implicit, points_flat, cfg.implicit, compute_dtype=fdtype
        )
        rgb_flat = render_forward(
            model.rendering, points_flat, grads, dirs_flat, feats, cfg.rendering,
            compute_dtype=fdtype,
        )
        lines3d_flat = attraction_forward(
            model.attraction, points_flat, grads, dirs_flat, feats, cfg.attraction,
            compute_dtype=fdtype,
        )
    rgb = rgb_flat.reshape(n_rays, n_samples, 3)

    density = laplace_density(
        sdf.reshape(n_rays, n_samples), model.density, beta_min=cfg.density_beta_min
    )
    weights = render_weights_from_density(z_vals, density)

    rgb_values = torch.sum(weights[..., None] * rgb, dim=1)
    if cfg.white_bkgd:
        acc = torch.sum(weights, dim=-1)
        bg = torch.tensor(cfg.bg_color, dtype=rgb_values.dtype, device=rgb_values.device)
        rgb_values = rgb_values + (1.0 - acc[..., None]) * bg

    out: Dict[str, torch.Tensor] = {
        "rgb_values": rgb_values,
        "depth": torch.sum(weights * depth_ratio, dim=-1),
        "xyz": torch.sum(points * weights[..., None], dim=1),
        "z_vals": z_vals,
        "weights": weights,
    }
    if not training:
        normals = grads.detach()
        normals = normals / torch.linalg.norm(normals, dim=-1, keepdim=True)
        out["normal_map"] = torch.sum(weights[..., None] * normals.reshape(n_rays, n_samples, 3), dim=1)

    # surface point and a second field evaluation there
    points3d = torch.sum(weights[..., None] * points, dim=1)
    points3d_sdf, _, points_gradients = implicit_sdf_feat_grad(
        model.implicit, points3d, cfg.implicit
    )

    lines3d = lines3d_flat.reshape(n_rays, n_samples, 2, 3)
    w_lines = weights.detach() if cfg.detach_line_weights else weights
    lines3d = torch.sum(w_lines[..., None, None] * lines3d, dim=1)  # (R, 2, 3)

    w2c = torch.linalg.inv(pose)
    rot, trans = w2c[:3, :3], w2c[:3, 3]
    k3 = intrinsics[:3, :3]
    eye3 = torch.eye(3, dtype=k3.dtype, device=k3.device)

    lines2d = project2d(k3, rot, trans, lines3d.detach() if cfg.detach_lines2d else lines3d)
    lines2d_calib = project2d(eye3, rot, trans, lines3d)

    # tangent-plane intersection of the attraction-support ray
    line_ray_d, line_ray_o = get_camera_params(inputs["uv_proj"][None], pose[None], intrinsics[None])
    line_ray_d = line_ray_d.reshape(-1, 3)
    line_ray_o = line_ray_o.expand(n_rays, 3)
    denominator = torch.sum(line_ray_d * points_gradients, dim=-1)
    denom_eps = torch.where(denominator >= 0, 1e-6, -1e-6).to(denominator.dtype)
    t = torch.sum((points3d - line_ray_o) * points_gradients, dim=-1) / (denominator + denom_eps)
    l3d = line_ray_o + line_ray_d * t.detach()[:, None]

    e1, e2 = lines3d[:, 0], lines3d[:, 1]
    l3d_score = (
        torch.linalg.norm(torch.cross(l3d - e1, l3d - e2, dim=-1), dim=-1)
        / torch.clamp(torch.linalg.norm(e1 - e2, dim=-1), min=1e-6)
    ).detach()

    out.update(
        {
            "l3d": l3d,
            "l3d_score": l3d_score,
            "points3d": points3d,
            "lines3d": lines3d,
            "lines2d": lines2d,
            "lines2d_calib": lines2d_calib,
            "sdf": points3d_sdf.flatten(),
            "K": k3,
        }
    )

    junctions3d_global = global_junctions_forward(model.junctions, cfg.junctions)

    if training:
        endpoints = lines3d.detach().reshape(-1, 3)
        if cfg.dbscan_enabled:
            proposals, prop_mask = dbscan_cluster_means(endpoints, eps=0.01, min_samples=2)
        elif cfg.use_l3d:
            med = torch.clamp(
                _masked_median(l3d_score, torch.ones_like(l3d_score, dtype=torch.bool)), min=0.01
            )
            sel = l3d_score < med
            proposals = torch.cat([endpoints, l3d], dim=0)
            prop_mask = torch.cat([torch.repeat_interleave(sel, 2), sel], dim=0)
        else:
            proposals = endpoints
            prop_mask = torch.ones((endpoints.shape[0],), dtype=torch.bool, device=endpoints.device)

        junctions2d = project2d(k3, rot, trans, proposals)
        junctions2d_calib = project2d(eye3, rot, trans, proposals)
        verts2d, verts_mask = inputs["verts2d"], inputs["verts_mask"]
        jcost = torch.sqrt(
            torch.sum((junctions2d[None] - verts2d[:, None]) ** 2, dim=-1) + 1e-12
        )
        col_idx, assign_valid = masked_assignment(
            jcost.detach(), verts_mask, prop_mask, method=cfg.assignment_method
        )
        col_idx = col_idx.long()
        assigned_cost = torch.gather(jcost, 1, col_idx[:, None])[:, 0]

        if cfg.use_median:
            median = _masked_median(assigned_cost.detach(), assign_valid)
            is_correct = assigned_cost < median
            out["median"] = median
        else:
            is_correct = assigned_cost < 10.0
        keep = assign_valid & is_correct

        out["j3d_local"] = proposals[col_idx]
        out["j2d_local"] = junctions2d[col_idx]
        out["j2d_local_calib"] = junctions2d_calib[col_idx]
        out["j_local_mask"] = keep
        out["j3d_global"] = junctions3d_global
        out["j2d_global"] = project2d(k3, rot, trans, junctions3d_global)
        out["j2d_global_calib"] = project2d(eye3, rot, trans, junctions3d_global)
        out["grad_theta"] = _eikonal_gradients(
            model, cfg, cam_loc, ray_dirs, z_eik, noise["eik_uniform"]
        )
    return out


def _eikonal_gradients(model, cfg: NeatConfig, cam_loc, ray_dirs, z_eik, eik_uniform):
    """Raw SDF gradients at uniform + near-surface points."""
    eik_near = (cam_loc[:, None, :] + z_eik[..., None] * ray_dirs[:, None, :]).reshape(-1, 3)
    pts = torch.cat([eik_uniform, eik_near], dim=0)
    return implicit_gradient(model.implicit, pts, cfg.implicit)


def render_rgb(model: NeatModel, inputs: Dict[str, torch.Tensor], cfg: NeatConfig) -> torch.Tensor:
    """Eval-mode RGB-only rendering (reference render_rgb, rend_a:344-375)."""
    return neat_forward(model, inputs, cfg, training=False)["rgb_values"]
