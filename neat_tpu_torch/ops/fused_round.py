"""K4: one refinement round of the error-bounded sampler, fused.

Replaces ``neat_tpu/ops/fused_round.py:_round_kernel`` (launched by
``fused_sampler_round``) with the CUDA kernel in ``csrc/fused_round.cu``.

What it computes, per ray, on the sorted proposals z and their sdf (R, S):
the interval lengths and the d* triangle bound; the Lemma-2 opacity-error
bound at beta0 (the convergence check); a ``beta_iters``-step bisection of
beta, each step one more evaluation of that bound (two prefix sums and a
row maximum); the volume-rendering weights at the chosen beta; and, when
``refine``, the error-driven pdf of the next round's inverse-CDF draw. The
draw itself, the proposal SDF evaluations and the merge sort stay outside,
as in the JAX package. ``fused_round_plain`` is the same math on full-width
masked arrays in plain PyTorch. It is the TPU kernel's math, not the
unfused sampler's: the Laplace density is written without ``expm1`` (two
branches, no cancellation), and the last lane counts as an interval (of
length 1e10) for the weights only.

What bounds it on the H100: nothing the card is short of. One round moves
four (R, S) f32 arrays (10.5 MB at 1024 x 640) and takes about 50
exponentials per sample: microseconds by either rate. Unfused, the same
round is 11 evaluations of the bound, each a dozen or so elementwise, scan
and reduction launches whose (R, S) operands go through device memory each
time; its cost is launch latency. The kernel's yardstick is therefore one
launch against those.

What the design does about it: one 128-thread block per ray, each thread
holding S / 128 consecutive samples (dists, sdf, d*) in registers across
all 11 evaluations of the bound; the two prefix sums are scanned together
(sequential in the thread, warp shuffles, one cross-warp step), the row
maximum is a shuffle reduction; weights and pdf leave through shared memory
so the stores are coalesced. S is a multiple of 128 up to 1024.

The ``err <= eps`` decisions sit on a knife edge: the kernel's prefix sums
add in another order than ``torch.cumsum``, so on a rare ray one decision
flips and that ray's beta moves by one bisection step. The source is
compiled without fused multiply-adds so that nothing else differs.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

_INF_DIST = 1e10


def _shift_down(a):
    """out[:, i] = a[:, i + 1], 0 at the last lane."""
    return torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=-1)


def _cumsum_excl(a):
    """out[:, i] = sum of a[:, :i]."""
    return torch.cat([torch.zeros_like(a[:, :1]), torch.cumsum(a, dim=-1)[:, :-1]], dim=-1)


def _laplace_density(sdf, beta):
    """alpha (0.5 + 0.5 sign(s) expm1(-|s| / beta)), alpha = 1 / beta,
    without expm1: 0.5 exp(-s / beta) for s >= 0, 1 - 0.5 exp(-|s| / beta)
    below; no cancellation in either branch."""
    e = torch.exp(-torch.abs(sdf) / beta)
    return torch.where(sdf >= 0.0, 0.5 * e, 1.0 - 0.5 * e) / beta


def _err_sec(beta, dists, d_star, interval):
    zero = torch.zeros_like(dists)
    return torch.where(
        interval, torch.exp(-d_star / beta) * (dists * dists) / (4.0 * beta * beta), zero
    )


def _clipped_expm1(v):
    return torch.clamp(torch.exp(v), max=1e6) - 1.0


def _error_bound_max(beta, sdf, dists, d_star, interval):
    """Max per-ray Lemma-2 opacity-error bound at beta (R, 1) -> (R, 1)."""
    zero = torch.zeros_like(dists)
    fe = torch.where(interval, dists * _laplace_density(sdf, beta), zero)
    err_int = torch.cumsum(_err_sec(beta, dists, d_star, interval), dim=-1)
    bound = _clipped_expm1(err_int) * torch.exp(-_cumsum_excl(fe))
    return torch.max(torch.where(interval, bound, zero), dim=-1, keepdim=True).values


def fused_round_plain(z, sdf, beta, beta0, eps, beta_iters, add_tiny, refine):
    """The round kernel's math in plain torch: z, sdf (R, S) f32 sorted
    along S, beta (R,), beta0 a scalar tensor -> (beta (R,), weights (R, S),
    pdf (R, S)); pdf's last column is 0, and all of it when not ``refine``."""
    lanes = z.shape[-1]
    zero = torch.zeros_like(z)
    interval = (torch.arange(lanes, device=z.device) < lanes - 1).expand(z.shape)
    dists = torch.where(interval, _shift_down(z) - z, zero)

    sdf_next = _shift_down(sdf)
    a, b, c = dists, torch.abs(sdf), torch.abs(sdf_next)
    first_cond = a * a + b * b <= c * c
    second_cond = a * a + c * c <= b * b
    s = (a + b + c) * 0.5
    area = s * (s - a) * (s - b) * (s - c)
    heron = 2.0 * torch.sqrt(torch.clamp(area, min=0.0)) / torch.clamp(a, min=1e-12)
    d_star = torch.where(first_cond, b, zero)
    d_star = torch.where(second_cond, c, d_star)
    other = (~first_cond) & (~second_cond) & (b + c - a > 0)
    d_star = torch.where(other, heron, d_star)
    same_sign = torch.sign(sdf_next) * torch.sign(sdf) == 1
    d_star = torch.where(same_sign & interval, d_star, zero)

    beta_in = beta[:, None]
    beta_lo = beta0.to(z.dtype).expand(beta_in.shape)
    curr_error = _error_bound_max(beta_lo, sdf, dists, d_star, interval)
    beta_hi = torch.where(curr_error <= eps, beta_lo, beta_in)
    for _ in range(beta_iters):
        beta_mid = 0.5 * (beta_lo + beta_hi)
        ok = _error_bound_max(beta_mid, sdf, dists, d_star, interval) <= eps
        beta_hi = torch.where(ok, beta_mid, beta_hi)
        beta_lo = torch.where(ok, beta_lo, beta_mid)

    dists_inf = torch.where(interval, dists, torch.full_like(dists, _INF_DIST))
    fe_inf = dists_inf * _laplace_density(sdf, beta_hi)
    transmittance = torch.exp(-_cumsum_excl(fe_inf))
    weights = (1.0 - torch.exp(-fe_inf)) * transmittance

    if refine:
        err_int = torch.cumsum(_err_sec(beta_hi, dists, d_star, interval), dim=-1)
        bound_opacity = _clipped_expm1(err_int) * transmittance
        pdf = torch.where(interval, bound_opacity + add_tiny, zero)
        pdf = pdf / torch.sum(pdf, dim=-1, keepdim=True)
    else:
        pdf = zero
    return beta_hi[:, 0], weights, pdf


def fused_round_kernel(z, sdf, beta, beta0, eps, beta_iters, add_tiny, refine):
    """Launch K4 on CUDA tensors: z, sdf (R, S) f32 contiguous with S a
    multiple of 128, beta (R,) f32, beta0 a one-element f32 tensor ->
    (beta (R,), weights (R, S), pdf (R, S))."""
    if not z.is_cuda:
        raise ValueError("fused_round kernel takes CUDA tensors")
    n_rays, lanes = z.shape
    for t, shape in ((z, (n_rays, lanes)), (sdf, (n_rays, lanes)), (beta, (n_rays,))):
        if t.shape != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("fused_round kernel takes contiguous f32 z, sdf (R, S) and beta (R,)")
    if beta0.numel() != 1 or beta0.dtype != torch.float32:
        raise ValueError("fused_round kernel takes beta0 as one f32 value on the device")
    for t in (sdf, beta, beta0):
        if t.device != z.device:
            raise ValueError("fused_round kernel operands must share one CUDA device")
    lib = _build.load("fused_round")
    lib.fused_round_max_samples.restype = ctypes.c_int
    if lanes % 128 != 0 or not 0 < lanes <= lib.fused_round_max_samples():
        raise ValueError(
            f"fused_round kernel takes a multiple of 128 samples up to "
            f"{lib.fused_round_max_samples()}, got {lanes}"
        )
    kw = dict(dtype=torch.float32, device=z.device)
    beta_out = torch.empty((n_rays,), **kw)
    weights, pdf = torch.empty((n_rays, lanes), **kw), torch.empty((n_rays, lanes), **kw)
    if n_rays == 0:
        return beta_out, weights, pdf
    fn = lib.fused_round
    fn.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                 ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    P = _build.ptr
    err = fn(
        P(z), P(sdf), P(beta), P(beta0), P(beta_out), P(weights), P(pdf), n_rays, lanes,
        eps, beta_iters, add_tiny, int(refine), _build.stream_ptr(z),
    )
    _build.check(err, "fused_round kernel launch")
    fused_round_kernel.launches += 1
    return beta_out, weights, pdf


fused_round_kernel.launches = 0


@torch.no_grad()
def fused_sampler_round(
    z_vals: torch.Tensor,
    sdf: torch.Tensor,
    beta: torch.Tensor,
    beta0: torch.Tensor,
    eps: float,
    beta_iters: int,
    add_tiny: float,
    refine: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused refinement round.

    z_vals, sdf: (R, S) f32 with S a multiple of 128; beta: (R,) carried
    bisection upper bound; beta0: scalar |beta| + beta_min target. Returns
    (beta (R,), weights (R, S), pdf (R, S)); pdf's last column is structural
    padding (S - 1 intervals), all zero when ``refine`` is False. CUDA
    tensors launch K4; CPU tensors run ``fused_round_plain``."""
    if z_vals.shape[-1] % 128 != 0:
        raise ValueError(f"fused rounds need a multiple of 128 samples, got {z_vals.shape[-1]}")
    z_vals, sdf, beta = (t.to(torch.float32).contiguous() for t in (z_vals, sdf, beta))
    beta0 = beta0.detach().to(torch.float32)
    if z_vals.is_cuda:
        return fused_round_kernel(
            z_vals, sdf, beta, beta0.reshape(1), eps, beta_iters, add_tiny, refine
        )
    return fused_round_plain(z_vals, sdf, beta, beta0, eps, beta_iters, add_tiny, refine)
