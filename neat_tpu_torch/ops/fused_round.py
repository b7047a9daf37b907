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

What bounds it on the H100: its instructions, not its bytes. Per sample,
each evaluation of the bound takes 4 exponentials and 4 IEEE divisions
(one MUFU operation each) among some hundred other instructions; a ray
needs 11 evaluations when its beta0 check fails and 1 when it passes (every
step after it keeps beta0). The weights, the pdf and d* add 7 to 12 more
special-function operations: 95 a sample without ``refine`` and 100 with it
when every check fails (``sfu_ops`` counts what given inputs need). At 16 a
clock on each of 132 SMs at 1.98 GHz that is about 15 us at 1024 x 640,
five times the time its four (R, S) f32 arrays take to cross device memory.
Unfused, the same round is 11 evaluations of the bound, each a dozen or so
elementwise, scan and reduction launches whose (R, S) operands go through
device memory each time.

What the design does about it: one 128-thread block per ray, each thread
holding S / 128 consecutive samples (dists, sdf, d*) in registers across
the evaluations of the bound; the two prefix sums are scanned together
(serial in the thread, warp shuffles, one step over the warps' totals),
the row maximum is a shuffle reduction and one step over the warps, and a
ray whose beta0 check passes skips the bisection; weights and pdf leave
through shared memory so the stores are coalesced. S is a multiple of 128
up to 1024.

The ``err <= eps`` decisions sit on a knife edge: the kernel's prefix sums
add in another order than ``torch.cumsum`` (``_cumsum_incl``,
``_cumsum_excl`` and ``_row_sum`` are the plain version's, one place each
for a test to put the kernel's order in), so on a rare ray one decision
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


def _cumsum_incl(a):
    """out[:, i] = sum of a[:, :i + 1]."""
    return torch.cumsum(a, dim=-1)


def _cumsum_excl(a):
    """out[:, i] = sum of a[:, :i]."""
    return torch.cat([torch.zeros_like(a[:, :1]), torch.cumsum(a, dim=-1)[:, :-1]], dim=-1)


def _row_sum(a):
    """The sum of each row, (R, S) -> (R, 1)."""
    return torch.sum(a, dim=-1, keepdim=True)


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
    err_int = _cumsum_incl(_err_sec(beta, dists, d_star, interval))
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
        err_int = _cumsum_incl(_err_sec(beta_hi, dists, d_star, interval))
        bound_opacity = _clipped_expm1(err_int) * transmittance
        pdf = torch.where(interval, bound_opacity + add_tiny, zero)
        pdf = pdf / _row_sum(pdf)
    else:
        pdf = zero
    return beta_hi[:, 0], weights, pdf


def sfu_ops(n_rays: int, lanes: int, beta_iters: int, refine: bool, n_passed: int = 0) -> int:
    """The special-function operations one round needs on (n_rays, lanes):
    each ``expf``, IEEE division and ``sqrtf``, one MUFU operation apiece.
    On each of the lanes - 1 intervals: 8 for each evaluation of the bound
    (the density's exp and two divisions, the interval error's exp and two
    divisions, the bound's two exps), beta_iters + 1 of them on a ray whose
    beta0 check fails and 1 on the n_passed rays whose check passes (every
    step after it keeps beta0), and 2 for d* (sqrtf, a division); on every
    lane 5 for the weights (the density's exp and two divisions, the
    transmittance's and alpha's exps); with ``refine``, 5 more on each
    interval (the interval error's exp and two divisions, the bound's exp,
    the pdf's normalising division)."""
    intervals = lanes - 1
    evaluations = n_passed + (n_rays - n_passed) * (beta_iters + 1)
    per_ray = intervals * 2 + lanes * 5 + (intervals * 5 if refine else 0)
    return n_rays * per_ray + evaluations * intervals * 8


def passed_check(z, sdf, beta0, eps) -> torch.Tensor:
    """(R,) bool: the rays whose bound at beta0 is within eps, which the
    round's bisection leaves at beta0 (plain torch)."""
    nan = torch.full(z.shape[:1], float("nan"), dtype=z.dtype, device=z.device)
    return fused_round_plain(z, sdf, nan, beta0, eps, 0, 0.0, False)[0] == beta0


_LIB = {}  # the loaded library and its widest row, once per process


def _lib():
    """(the round kernel's library, the widest row it takes); the C
    signatures are set once, when the library first loads."""
    if not _LIB:
        lib = _build.load("fused_round")
        lib.fused_round_max_samples.restype = ctypes.c_int
        lib.fused_round.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        lib.fused_round.restype = ctypes.c_int
        _LIB.update(lib=lib, max_samples=lib.fused_round_max_samples())
    return _LIB["lib"], _LIB["max_samples"]


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
    lib, max_samples = _lib()
    if lanes % 128 != 0 or not 0 < lanes <= max_samples:
        raise ValueError(f"fused_round kernel takes a multiple of 128 samples up to {max_samples}, got {lanes}")
    kw = dict(dtype=torch.float32, device=z.device)
    beta_out = torch.empty((n_rays,), **kw)
    weights, pdf = torch.empty((n_rays, lanes), **kw), torch.empty((n_rays, lanes), **kw)
    if n_rays == 0:
        return beta_out, weights, pdf
    P = _build.ptr
    err = lib.fused_round(
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
