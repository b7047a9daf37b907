"""Volume rendering weights (port of neat_tpu/core/render.py).

    dists_i = z_{i+1} - z_i (last 1e10), fe_i = dists_i * sigma_i,
    alpha_i = 1 - exp(-fe_i), T_i = exp(-cumsum_{j<i} fe_j), w_i = alpha_i T_i
"""

from __future__ import annotations

import torch

_INF_DIST = 1e10


def alpha_transmittance(z_vals: torch.Tensor, density: torch.Tensor):
    """(alpha, transmittance, dists) — the error-bounded sampler needs the
    transmittance separately."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists_inf = torch.cat([dists, torch.full_like(dists[..., :1], _INF_DIST)], dim=-1)
    free_energy = dists_inf * density
    shifted = torch.cat(
        [torch.zeros_like(free_energy[..., :1]), free_energy[..., :-1]], dim=-1
    )
    alpha = 1.0 - torch.exp(-free_energy)
    transmittance = torch.exp(-torch.cumsum(shifted, dim=-1))
    return alpha, transmittance, dists


def render_weights_from_density(z_vals: torch.Tensor, density: torch.Tensor):
    """z_vals, density: (..., S) -> weights (..., S)."""
    alpha, transmittance, _ = alpha_transmittance(z_vals, density)
    return alpha * transmittance


def volume_rendering_weights(z_vals: torch.Tensor, sdf: torch.Tensor, density_params, beta_min: float = 1e-4):
    """Laplace-density volume rendering weights of per-ray samples:
    z_vals, sdf (..., S) -> weights (..., S)."""
    from .density import laplace_density

    return render_weights_from_density(z_vals, laplace_density(sdf, density_params, beta_min=beta_min))
