"""NeRF-style sinusoidal positional encoding (port of neat_tpu/core/embedder.py).

Layout: ``[x, sin(2^0 x), cos(2^0 x), ..., sin(2^{m-1} x), cos(2^{m-1} x)]``.
"""

from __future__ import annotations

import numpy as np
import torch


def encoding_dim(multires: int, input_dims: int = 3) -> int:
    """Output dimension of :func:`positional_encoding`."""
    if multires <= 0:
        return input_dims
    return input_dims * (1 + 2 * multires)


def positional_encoding(x: torch.Tensor, multires: int) -> torch.Tensor:
    """Encode ``x`` (..., D) -> (..., D * (1 + 2*multires))."""
    if multires <= 0:
        return x
    freqs = torch.as_tensor(
        2.0 ** np.linspace(0.0, multires - 1, multires), dtype=x.dtype, device=x.device
    )
    xb = x[..., None, :] * freqs[:, None]  # (..., M, D)
    sc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)  # (..., M, 2, D)
    sc = sc.reshape(*x.shape[:-1], 2 * multires * x.shape[-1])
    return torch.cat([x, sc], dim=-1)
