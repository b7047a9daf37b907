"""The NEAT model: VolSDF surface + attraction field + global junctions
(port of neat_tpu/model/neat.py), with the reference's ablation classes as
flags: the vanilla VolSDF network (``model_variant='volsdf'``), the
uniform sampler, the attraction at the surface point (the wfr family),
endpoint rendering along the ray with an optional second SDF, DBSCAN over
the global junctions too, and junction eikonal points.

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
from ..core.render import render_weights_from_density, volume_rendering_weights
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
    UniformSamplerConfig,
    error_bound_z_vals,
    total_final_samples,
    total_proposal_samples,
    uniform_z_vals,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class NeatConfig:
    """Field for field the JAX ``NeatConfig``. In this package the kernel
    flags select the hand-written CUDA kernels: ``use_pallas_sampler`` ->
    K1, ``use_pallas_field`` -> K2 (``pallas_field_backward='stash'``) or
    K3 (``'recompute'``). Every variant flag of the JAX config runs."""

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


def check_ported(cfg: NeatConfig) -> None:
    """Raise for a flag value neither package knows."""
    choices = {
        "model_variant": ("neat", "volsdf"),
        "sampler_kind": ("error_bound", "uniform"),
        "attraction_aggregation": ("weighted", "endpoint_render"),
        "pallas_field_backward": ("stash", "recompute"),
    }
    for name, allowed in choices.items():
        if getattr(cfg, name) not in allowed:
            raise ValueError(f"NeatConfig.{name} is one of {allowed}, got {getattr(cfg, name)!r}")


class NeatModel(nn.Module):
    """Parameter container: implicit, rendering, attraction (layer stacks
    of lin0..), density (beta), junctions (latents + ffn) and neat_sdf (a
    second implicit stack, ``endpoint_sdf_separate``). The vanilla VolSDF
    network (``model_variant='volsdf'``) has no attraction, junctions or
    neat_sdf: those are None and absent from the state dict."""

    def __init__(self, implicit, rendering, attraction=None, density=None, junctions=None, neat_sdf=None):
        super().__init__()
        self.implicit = implicit
        self.rendering = rendering
        self.attraction = attraction
        self.density = density
        self.junctions = junctions
        self.neat_sdf = neat_sdf


def init_neat(cfg: NeatConfig, seed: int = 0, device="cuda") -> NeatModel:
    """Random weights from ``seed`` (drawn on the CPU, so every device gets
    the same ones), moved to ``device``: the modules of ``cfg``'s variant,
    drawn in the order implicit, rendering, attraction, junctions,
    neat_sdf."""
    check_ported(cfg)
    gen = torch.Generator().manual_seed(seed)
    implicit = init_implicit_net(gen, cfg.implicit)
    rendering = init_render_net(gen, cfg.rendering)
    heads = {}
    if cfg.model_variant == "neat":
        heads["attraction"] = init_attraction_net(gen, cfg.attraction)
        heads["junctions"] = init_global_junctions(gen, cfg.junctions)
        if cfg.endpoint_sdf_separate:
            heads["neat_sdf"] = init_implicit_net(gen, cfg.implicit)
    model = NeatModel(implicit, rendering, density=LaplaceDensity(cfg.density_beta_init), **heads)
    return model.to(device)


def draw_forward_noise(gen: torch.Generator, n_rays: int, cfg: NeatConfig, device="cuda"):
    """Every random array a training-mode ``neat_forward`` consumes: per-ray
    eik_uniform, strat, eik_z_idx, and for the error-bounded sampler
    final_u and the ray-shared z_extra_idx."""
    s = cfg.sampler
    bs = cfg.scene_bounding_sphere
    kw = dict(generator=gen, device=device)
    noise = {"eik_uniform": torch.rand((n_rays, 3), **kw) * (2 * bs) - bs}
    if cfg.sampler_kind == "uniform":
        noise["strat"] = torch.rand((n_rays, s.n_samples), **kw)
        noise["eik_z_idx"] = torch.randint(0, s.n_samples, (n_rays, 1), **kw)
        return noise
    noise["strat"] = torch.rand((n_rays, s.n_samples_eval), **kw)
    noise["final_u"] = torch.rand((n_rays, s.n_samples), **kw)
    noise["eik_z_idx"] = torch.randint(0, total_final_samples(s), (n_rays, 1), **kw)
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
    """(z_vals, z_eik): the ray's samples and, in training, the one each
    ray's near-surface eikonal point is taken at."""
    if cfg.sampler_kind == "uniform":  # neat_uni: no proposal evaluations
        ucfg = UniformSamplerConfig(
            scene_bounding_sphere=cfg.scene_bounding_sphere, near=cfg.sampler.near, n_samples=cfg.sampler.n_samples
        )
        z = uniform_z_vals(ray_dirs, cam_loc, ucfg, training, t_rand=noise["strat"] if training else None)
        z_eik = torch.gather(z, -1, noise["eik_z_idx"]) if training else None
        return z.detach(), None if z_eik is None else z_eik.detach()
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
    # the fused field kernels take the neat network only, as in the JAX package
    lines3d_flat = None
    if cfg.use_pallas_field and cfg.model_variant == "neat":
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
        if cfg.model_variant == "neat" and not cfg.attraction_at_surface:
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

    if cfg.model_variant != "neat":  # vanilla VolSDF: the eikonal points and done
        out["sdf"] = sdf.reshape(n_rays, n_samples).detach()
        if training:
            out["grad_theta"] = _eikonal_gradients(model, cfg, cam_loc, ray_dirs, z_eik, noise["eik_uniform"])
        return out

    # surface point and a second field evaluation there
    points3d = torch.sum(weights[..., None] * points, dim=1)
    points3d_sdf, points3d_feats, points_gradients = implicit_sdf_feat_grad(
        model.implicit, points3d, cfg.implicit
    )

    if cfg.attraction_at_surface:
        # the wfr family: one attraction evaluation at the detached surface
        # point with its detached implicit outputs
        lines3d = attraction_forward(
            model.attraction, points3d.detach(), points_gradients.detach(), ray_dirs.detach(),
            points3d_feats.detach(), cfg.attraction, compute_dtype=fdtype,
        ).reshape(n_rays, 2, 3)
    elif cfg.attraction_aggregation == "endpoint_render":
        lines3d, out["score"] = _endpoint_render(
            model, cfg, lines3d_flat.reshape(n_rays, n_samples, 2, 3), cam_loc
        )
    else:
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

    if cfg.eval_attraction_at_l3d and not training:
        # the wfr / simple eval branch: the attraction again at l3d with
        # fresh detached implicit outputs; 'sdf' follows, lines2d_calib
        # keeps the surface point's segments
        l3d_stop = l3d.detach()
        points3d_sdf, l3d_feats, l3d_grads = implicit_sdf_feat_grad(model.implicit, l3d_stop, cfg.implicit)
        lines3d = attraction_forward(
            model.attraction, l3d_stop, l3d_grads.detach(), ray_dirs.detach(), l3d_feats.detach(),
            cfg.attraction, compute_dtype=fdtype,
        ).reshape(n_rays, 2, 3)
        lines2d = project2d(k3, rot, trans, lines3d)

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
            cluster_input = endpoints
            if cfg.dbscan_include_global:  # rend_c: the global junctions join the cloud
                cluster_input = torch.cat([endpoints, junctions3d_global.detach()], dim=0)
            proposals, prop_mask = dbscan_cluster_means(cluster_input, eps=0.01, min_samples=2)
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
            model, cfg, cam_loc, ray_dirs, z_eik, noise["eik_uniform"],
            junctions3d_global.detach() if cfg.junction_eikonal else None,
        )
    return out


def _endpoint_render(model, cfg: NeatConfig, lines3d, cam_loc):
    """The along-ray family: each endpoint track (R, S, 3) sorted by its
    camera distance and volume-rendered with weights from its own SDF
    evaluation (input detached; ``neat_sdf`` with ``endpoint_sdf_separate``).
    -> (lines3d (R, 2, 3), score (R,): the mean of the tracks' peak weights).
    The sort is stable, as jnp.argsort's: tied distances keep their order."""
    n_rays, n_samples = lines3d.shape[:2]
    sdf_net = model.neat_sdf if cfg.endpoint_sdf_separate else model.implicit
    ek = lines3d.transpose(1, 2).reshape(2 * n_rays, n_samples, 3)
    sdf_e = implicit_sdf(sdf_net, ek.reshape(-1, 3).detach(), cfg.implicit)[..., 0].reshape(2 * n_rays, n_samples)
    cam2 = torch.repeat_interleave(cam_loc, 2, dim=0)
    z_e = torch.linalg.norm(ek - cam2[:, None, :], dim=-1).detach()
    order = torch.argsort(z_e, dim=-1, stable=True)
    w_e = volume_rendering_weights(
        torch.gather(z_e, -1, order), torch.gather(sdf_e, -1, order), model.density, beta_min=cfg.density_beta_min
    )
    ek_s = torch.gather(ek, 1, order[..., None].expand(-1, -1, 3))
    lines3d = torch.sum(w_e[..., None] * ek_s, dim=1).reshape(n_rays, 2, 3)
    score = torch.mean(torch.amax(w_e, dim=-1).reshape(n_rays, 2), dim=-1)
    return lines3d, score


def _eikonal_gradients(model, cfg: NeatConfig, cam_loc, ray_dirs, z_eik, eik_uniform, extra_points=None):
    """Raw SDF gradients at uniform + near-surface points, and the detached
    global junctions with ``junction_eikonal``."""
    eik_near = (cam_loc[:, None, :] + z_eik[..., None] * ray_dirs[:, None, :]).reshape(-1, 3)
    pts = [eik_uniform, eik_near] + ([] if extra_points is None else [extra_points])
    return implicit_gradient(model.implicit, torch.cat(pts, dim=0), cfg.implicit)


def render_rgb(model: NeatModel, inputs: Dict[str, torch.Tensor], cfg: NeatConfig) -> torch.Tensor:
    """Eval-mode RGB-only rendering (reference render_rgb, rend_a:344-375)."""
    return neat_forward(model, inputs, cfg, training=False)["rgb_values"]
