"""SDF -> Laplace density (port of neat_tpu/core/density.py).

    alpha * (0.5 + 0.5 * sign(s) * expm1(-|s|/beta)),  alpha = 1/beta

``expm1`` stays here as in the JAX XLA path; only the fused field kernel
writes sigma' with ``exp``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class LaplaceDensity(nn.Module):
    """Learnable state of the Laplace density: a single scalar ``beta``."""

    def __init__(self, beta: float = 0.1):
        super().__init__()
        self.beta = nn.Parameter(torch.tensor(beta, dtype=torch.float32))


def get_beta(params, beta_min: float = 1e-4) -> torch.Tensor:
    """Effective beta: |beta| + beta_min. ``params`` has a ``beta`` tensor."""
    return torch.abs(params.beta) + beta_min


def laplace_density(
    sdf: torch.Tensor,
    params,
    beta_min: float = 1e-4,
    beta: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Laplace CDF density of the (negated) SDF; ``beta`` overrides the
    learnable value (the error-bounded sampler's bisection)."""
    if beta is None:
        beta = get_beta(params, beta_min)
    alpha = 1.0 / beta
    return alpha * (0.5 + 0.5 * torch.sign(sdf) * torch.expm1(-torch.abs(sdf) / beta))
