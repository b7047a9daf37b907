"""Ray samplers: uniform and VolSDF error-bounded (port of
neat_tpu/sampling/samplers.py).

Same static schedule as the JAX package: always ``max_total_iters``
refinement rounds (128 -> 256 -> ... -> 640 proposals), each an SDF
evaluation, the d* triangle bound, a 10-step beta bisection and an
error-driven inverse-CDF resample; then the final draw of ``n_samples``
from the rendering weights plus ``n_samples_extra`` leftovers and the
near/far endpoints. With ``fused_rounds='on'`` a round's bookkeeping (d*,
bisection, weights, refinement pdf) is one launch of the round kernel K4.
All outputs are constants to autograd.

Random draws come in through the same ``noise`` dict as the JAX function
(``model.neat.draw_forward_noise`` makes it), so z values compare draw for
draw. The proposal SDF callback is where the fused SDF kernel (K1) plugs in.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import torch

from ..core.camera import get_sphere_intersections
from ..core.density import get_beta, laplace_density
from ..core.render import alpha_transmittance


def _invert_cdf(bins, cdf, u):
    """Inverse-CDF draw. bins: (R, S) ascending; cdf: (R, S) non-decreasing
    with cdf[:, 0] = 0; u: (R, N). Returns (R, N).

    ``below`` is the last index with cdf <= u and ``above`` the first with
    cdf > u (clamped to the last entry): the same four values the JAX code
    takes as masked max/min reductions, here found with searchsorted."""
    s = cdf.shape[-1]
    above = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = above - 1
    above = above.clamp(max=s - 1)
    cdf_b, cdf_a = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    bins_b, bins_a = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)


def sample_pdf(bins, weights, n_samples: int, det: bool = False, u=None):
    """Hierarchical sampling. bins: (R, S); weights: (R, S-1); ``u`` is the
    (R, n_samples) uniform draw (ignored when ``det``)."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    if det:
        u = torch.linspace(0.0, 1.0, n_samples, dtype=cdf.dtype, device=cdf.device)
        u = u.expand(*cdf.shape[:-1], n_samples)
    return _invert_cdf(bins, cdf, u)


@dataclasses.dataclass(frozen=True)
class UniformSamplerConfig:
    scene_bounding_sphere: float = 3.0
    near: float = 0.0
    n_samples: int = 64
    take_sphere_intersection: bool = False
    far: float = -1.0  # -1 -> 2 * bounding sphere

    @property
    def far_value(self) -> float:
        return 2.0 * self.scene_bounding_sphere if self.far == -1.0 else self.far


def uniform_z_vals(ray_dirs, cam_loc, cfg: UniformSamplerConfig, training: bool, t_rand=None):
    """Uniform (stratified when training, by ``t_rand``) z values (R, n)."""
    n_rays = ray_dirs.shape[0]
    kw = dict(dtype=ray_dirs.dtype, device=ray_dirs.device)
    near = torch.full((n_rays, 1), cfg.near, **kw)
    if cfg.take_sphere_intersection:
        far = get_sphere_intersections(cam_loc, ray_dirs, radius=cfg.scene_bounding_sphere)[:, 1:]
    else:
        far = torch.full((n_rays, 1), cfg.far_value, **kw)
    t = torch.linspace(0.0, 1.0, cfg.n_samples, **kw)
    z_vals = near * (1.0 - t) + far * t
    if training:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mids], dim=-1)
        z_vals = lower + (upper - lower) * t_rand
    return z_vals


@dataclasses.dataclass(frozen=True)
class ErrorBoundSamplerConfig:
    scene_bounding_sphere: float = 3.0
    near: float = 0.0
    n_samples: int = 64
    n_samples_eval: int = 128
    n_samples_extra: int = 32
    eps: float = 0.1
    beta_iters: int = 10
    max_total_iters: int = 5
    add_tiny: float = 0.0
    inverse_sphere_bg: bool = False
    # 'bisect' = the 10-step sequential line search; 'grid' evaluates the
    # error bound at beta_grid_size log-spaced betas in one batched pass
    # and takes the smallest admissible one
    beta_search: str = "bisect"
    beta_grid_size: int = 32
    # 'on' runs each refinement round's bookkeeping (d*, the beta bisection,
    # weights, refinement pdf) through the round kernel K4
    # (ops/fused_round.py). It needs R % 128 == 0, n_samples_eval % 128 == 0
    # and the bisect search; other shapes take the unfused path, as in the
    # JAX package. The JAX 'interpret' value has no counterpart: on CPU
    # tensors 'on' runs the kernel's plain version.
    fused_rounds: str = "off"  # 'off' | 'on'

    @property
    def far_value(self) -> float:
        return 2.0 * self.scene_bounding_sphere


def _d_star(z_vals, sdf):
    """Theorem-1 minimal distance bound per interval. (R, S) -> (R, S-1)."""
    d = sdf
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    a, b, c = dists, torch.abs(d[..., :-1]), torch.abs(d[..., 1:])
    first_cond = a**2 + b**2 <= c**2
    second_cond = a**2 + c**2 <= b**2
    s = (a + b + c) / 2.0
    area = s * (s - a) * (s - b) * (s - c)
    heron = (2.0 * torch.sqrt(torch.clamp(area, min=0.0))) / torch.clamp(a, min=1e-12)
    d_star = torch.zeros_like(a)
    d_star = torch.where(first_cond, b, d_star)
    d_star = torch.where(second_cond, c, d_star)
    mask = (~first_cond) & (~second_cond) & (b + c - a > 0)
    d_star = torch.where(mask, heron, d_star)
    same_sign = torch.sign(d[..., 1:]) * torch.sign(d[..., :-1]) == 1
    return torch.where(same_sign, d_star, torch.zeros_like(d_star))


def _error_bound(beta, density_params, beta_min, sdf, dists, d_star):
    """Max per-ray opacity-error bound at ``beta`` ((R, 1) or scalar) -> (R,)."""
    density = laplace_density(sdf, density_params, beta_min=beta_min, beta=beta)
    fe = dists * density[..., :-1]
    shifted = torch.cat([torch.zeros_like(fe[..., :1]), fe], dim=-1)
    integral = torch.cumsum(shifted, dim=-1)
    err_sec = torch.exp(-d_star / beta) * (dists**2) / (4.0 * beta**2)
    err_int = torch.cumsum(err_sec, dim=-1)
    bound = (torch.clamp(torch.exp(err_int), max=1e6) - 1.0) * torch.exp(-integral[..., :-1])
    return torch.max(bound, dim=-1).values


def total_proposal_samples(cfg: ErrorBoundSamplerConfig) -> int:
    return cfg.n_samples_eval * cfg.max_total_iters


def total_final_samples(cfg: ErrorBoundSamplerConfig) -> int:
    return cfg.n_samples + cfg.n_samples_extra + 2


def _sort_carry(z, sdf):
    z_sorted, order = torch.sort(z, dim=-1, stable=True)
    return z_sorted, torch.gather(sdf, -1, order)


@torch.no_grad()
def error_bound_z_vals(
    ray_dirs,
    cam_loc,
    sdf_fn: Callable[[torch.Tensor], torch.Tensor],
    density_params,
    cfg: ErrorBoundSamplerConfig,
    training: bool,
    beta_min: float = 1e-4,
    noise: dict = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """VolSDF Algorithm-1 sampling with static shapes.

    sdf_fn: (N, 3) -> (N,) clamped SDF. Returns (z_vals (R, n_samples +
    n_samples_extra + 2), z_eik (R, 1)). In training mode ``noise`` holds
    every random draw: strat (R, n_samples_eval), final_u (R, n_samples),
    z_extra_idx (n_samples_extra,), eik_z_idx (R, 1).
    """
    if cfg.beta_search not in ("bisect", "grid") or cfg.fused_rounds not in ("off", "on"):
        raise ValueError(
            f"beta_search is 'bisect' or 'grid' and fused_rounds 'off' or 'on', got "
            f"{cfg.beta_search!r} and {cfg.fused_rounds!r}"
        )
    noise = noise or {}
    n_rays = ray_dirs.shape[0]
    kw = dict(dtype=ray_dirs.dtype, device=ray_dirs.device)

    beta0 = get_beta(density_params, beta_min).detach()
    uni_cfg = UniformSamplerConfig(
        scene_bounding_sphere=cfg.scene_bounding_sphere,
        near=cfg.near,
        n_samples=cfg.n_samples_eval,
        take_sphere_intersection=cfg.inverse_sphere_bg,
    )
    z_vals = uniform_z_vals(ray_dirs, cam_loc, uni_cfg, training, t_rand=noise.get("strat"))

    def eval_sdf(z):
        pts = cam_loc[:, None, :] + z[..., None] * ray_dirs[:, None, :]
        return sdf_fn(pts.reshape(-1, 3)).reshape(z.shape).to(z.dtype)

    sdf = eval_sdf(z_vals)

    dists0 = z_vals[..., 1:] - z_vals[..., :-1]
    bound = (1.0 / (4.0 * math.log(cfg.eps + 1.0))) * torch.sum(dists0**2, -1)
    beta = torch.sqrt(bound)

    # the round kernel hard-codes the bisection, so a grid search keeps the
    # unfused path (swapping the search silently would spoil a comparison)
    use_fused_rounds = (
        cfg.fused_rounds == "on"
        and n_rays % 128 == 0
        and cfg.n_samples_eval % 128 == 0
        and cfg.beta_search == "bisect"
    )

    u_lin = torch.linspace(0.0, 1.0, cfg.n_samples_eval, **kw).expand(n_rays, -1)

    def refined(z_vals, sdf, pdf):
        """Draw n_samples_eval more proposals from the interval pdf (R, S-1)
        and merge them, sorted, with their sdf."""
        cdf = torch.cumsum(pdf, dim=-1)
        cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
        new_z = _invert_cdf(z_vals, cdf, u_lin)
        return _sort_carry(
            torch.cat([z_vals, new_z], dim=-1), torch.cat([sdf, eval_sdf(new_z)], dim=-1)
        )

    weights = None
    for it in range(cfg.max_total_iters):
        refine = it < cfg.max_total_iters - 1
        if use_fused_rounds:
            from ..ops.fused_round import fused_sampler_round

            beta, weights, pdf_full = fused_sampler_round(
                z_vals, sdf, beta, beta0, eps=cfg.eps, beta_iters=cfg.beta_iters,
                add_tiny=cfg.add_tiny, refine=refine,
            )
            if refine:
                z_vals, sdf = refined(z_vals, sdf, pdf_full[:, :-1])
            continue

        dists = z_vals[..., 1:] - z_vals[..., :-1]
        d_star = _d_star(z_vals, sdf)

        curr_error = _error_bound(beta0, density_params, beta_min, sdf, dists, d_star)
        beta = torch.where(curr_error <= cfg.eps, beta0, beta)
        if cfg.beta_search == "grid":
            # one batched evaluation at log-spaced candidates in [beta0, beta]
            t = torch.linspace(0.0, 1.0, cfg.beta_grid_size, **kw)
            ratio = torch.clamp(beta / beta0, min=1.0)
            betas = beta0 * ratio[:, None] ** t[None, :]  # (R, K), ascending
            err = _error_bound(
                betas[:, :, None], density_params, beta_min,
                sdf[:, None, :], dists[:, None, :], d_star[:, None, :],
            )  # (R, K)
            ok = err <= cfg.eps
            first = torch.argmax(ok.to(torch.int8), dim=-1)
            chosen = torch.gather(betas, -1, first[:, None])[:, 0]
            beta = torch.where(torch.any(ok, dim=-1), chosen, beta)
        else:
            beta_lo = beta0.to(ray_dirs.dtype).expand(n_rays)
            beta_hi = beta
            for _ in range(cfg.beta_iters):
                beta_mid = 0.5 * (beta_lo + beta_hi)
                err = _error_bound(beta_mid[:, None], density_params, beta_min, sdf, dists, d_star)
                ok = err <= cfg.eps
                beta_hi = torch.where(ok, beta_mid, beta_hi)
                beta_lo = torch.where(ok, beta_lo, beta_mid)
            beta = beta_hi

        density = laplace_density(sdf, density_params, beta_min=beta_min, beta=beta[:, None])
        alpha, transmittance, _ = alpha_transmittance(z_vals, density)
        weights = alpha * transmittance

        if refine:
            err_sec = (
                torch.exp(-d_star / beta[:, None]) * (dists**2) / (4.0 * beta[:, None] ** 2)
            )
            err_int = torch.cumsum(err_sec, dim=-1)
            bound_opacity = (torch.clamp(torch.exp(err_int), max=1e6) - 1.0) * transmittance[..., :-1]
            pdf = bound_opacity + cfg.add_tiny
            z_vals, sdf = refined(z_vals, sdf, pdf / torch.sum(pdf, dim=-1, keepdim=True))

    z_samples = sample_pdf(
        z_vals, weights[..., :-1], cfg.n_samples, det=not training, u=noise.get("final_u")
    )

    near = torch.full((n_rays, 1), cfg.near, **kw)
    if cfg.inverse_sphere_bg:
        far = get_sphere_intersections(cam_loc, ray_dirs, radius=cfg.scene_bounding_sphere)[:, 1:]
    else:
        far = torch.full((n_rays, 1), cfg.far_value, **kw)

    total = z_vals.shape[-1]
    if cfg.n_samples_extra > 0:
        if training:
            idx = noise["z_extra_idx"]
        else:
            idx = torch.linspace(0, total - 1, cfg.n_samples_extra).to(torch.int32)
        z_extra = torch.cat([near, far, z_vals[:, idx.long().to(z_vals.device)]], dim=-1)
    else:
        z_extra = torch.cat([near, far], dim=-1)

    z_all = torch.sort(torch.cat([z_samples, z_extra], dim=-1), dim=-1).values
    z_eik = torch.gather(z_all, -1, noise["eik_z_idx"].long()) if training else None
    return z_all, z_eik
