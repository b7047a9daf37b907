"""Plain PyTorch reference of one NEAT training step, for the benchmark's
check of what the timed path produced.

It follows the published method (NEAT, arXiv 2307.10206; VolSDF's
error-bounded sampler) as the benchmarked configurations run it: the
error-bounded sampler over a weight-normalised 8-layer SDF MLP with a skip
and a frequency encoding, volume rendering with the Laplace density, the
IDR colour and attraction heads on the SDF's gradient and features, the
attraction-weighted 3D line segments, DBSCAN proposals (where the
configuration clusters) or the raw endpoints, the auction assignment of
the 2D junctions, the median or fixed gate, the line, colour, eikonal and
junction loss terms, and optax's Adam with the exponential decay.

It imports nothing of the program. Its parameters are a dict ``name ->
tensor`` under the program's leaf names, so that the check compares leaf
with leaf. Departures from the program's own arithmetic, each on purpose:

* the SDF's spatial gradient is carried forward as three tangent columns
  through the chain (the chain rule written out), not by automatic
  differentiation of a gradient, so that the field pass can run in blocks
  of points under ``torch.utils.checkpoint`` and fit on one card;
* the surface-point evaluation is left out: no loss term reads it;
* every product is float32 with TF32 off, unless a ``Precision`` says
  otherwise (the control: ``fp8`` rounds both operands of a field or
  sampler product to float8 e4m3 with a scale per tensor, and ``tf32``
  lets the other float32 products run in TF32).

Random draws are replayed from the same per-step generator seeding the
training runner uses, in the same order and shapes, on the same device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
_BIG = 1e9
_INF_DIST = 1e10
FIELD_BLOCK = 65536  # points a field block holds (checkpointed)
SAMPLER_BLOCK = 262144  # points a sampler block evaluates


@dataclasses.dataclass(frozen=True)
class Precision:
    """The precision of each group of products: ``field`` (the main field
    pass), ``sampler`` (the proposal SDF) in ``f32`` or ``fp8``; ``other``
    (everything else) in ``f32`` or ``tf32``."""

    field: str = "f32"
    sampler: str = "f32"
    other: str = "f32"


F32 = Precision()
CONTROL = Precision(field="fp8", sampler="fp8", other="tf32")


class _RoundFp8(torch.autograd.Function):
    """Round to float8 e4m3 with a per-tensor scale; the gradient passes
    through unchanged."""

    @staticmethod
    def forward(ctx, x):
        amax = torch.clamp(x.detach().abs().amax(), min=1e-12)
        scale = amax / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def _q(x: torch.Tensor, mode: str) -> torch.Tensor:
    return _RoundFp8.apply(x) if mode == "fp8" else x


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], mode: str) -> torch.Tensor:
    """x @ w.T + b with both operands at ``mode``'s precision."""
    y = _q(x, mode) @ _q(w, mode).T
    return y if b is None else y + b


# ---------------------------------------------------------------------------
# configuration: the numbers the configuration file states
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RefConfig:
    """The model, loss and optimiser numbers of one configuration, read
    from the benchmark's configuration file (``from_file``)."""

    feature: int
    bound_sphere: float
    implicit_dims: Tuple[int, ...]
    skip_in: Tuple[int, ...]
    multires: int
    sphere_scale: float
    render_dims: Tuple[int, ...]
    render_multires_view: int
    attraction_dims: Tuple[int, ...]
    junction_layers: int
    beta_min: float
    n_samples: int
    n_samples_eval: int
    n_samples_extra: int
    sampler_eps: float
    beta_iters: int
    max_total_iters: int
    dbscan: bool
    use_median: bool
    eikonal_weight: float
    line_weight: float
    junction_3d_weight: float
    junction_2d_weight: float
    line_gate_px: float
    junction_cost_2d_scale: float
    learning_rate: float
    decay_rate: float
    nepochs: int

    @staticmethod
    def from_file(cfg: dict) -> "RefConfig":
        m, l, t = cfg["model"], cfg["loss"], cfg["train"]
        imp, ren, att, jun, s = m["implicit"], m["rendering"], m["attraction"], m["junctions"], m["sampler"]
        for head in (ren, att):
            if head["mode"] != "idr" or head["d_in"] != 9:
                raise ValueError("the reference implements the IDR heads with 9 inputs besides the features")
        if imp["d_in"] != 3 or imp["d_out"] != 1 or not imp["geometric_init"] or not imp["weight_norm"]:
            raise ValueError("the reference implements the 3-in, 1-out weight-normed SDF network")
        if l["rgb_loss"] != "l1" or l["junction_mode"] != "wfr" or not l["calibrated_branch"]:
            raise ValueError("the reference implements the L1 colour loss and the wfr junction terms")
        return RefConfig(
            feature=m["feature_vector_size"], bound_sphere=m["scene_bounding_sphere"],
            implicit_dims=tuple(imp["dims"]), skip_in=tuple(imp["skip_in"]), multires=imp["multires"],
            sphere_scale=imp["sphere_scale"],
            render_dims=tuple(ren["dims"]), render_multires_view=ren["multires_view"],
            attraction_dims=tuple(att["dims"]),
            junction_layers=jun["num_layers"],
            beta_min=m["density_beta_min"],
            n_samples=s["n_samples"], n_samples_eval=s["n_samples_eval"], n_samples_extra=s["n_samples_extra"],
            sampler_eps=s["eps"], beta_iters=s["beta_iters"], max_total_iters=s["max_total_iters"],
            dbscan=m["dbscan_enabled"], use_median=m["use_median"],
            eikonal_weight=l["eikonal_weight"], line_weight=l["line_weight"],
            junction_3d_weight=l["junction_3d_weight"], junction_2d_weight=l["junction_2d_weight"],
            line_gate_px=l["line_gate_px"], junction_cost_2d_scale=l["junction_cost_2d_scale"],
            learning_rate=t["learning_rate"], decay_rate=t["sched_decay_rate"], nepochs=t["nepochs"],
        )

    @property
    def encoding(self) -> int:
        return 3 * (1 + 2 * self.multires)

    def implicit_layers(self) -> List[Tuple[int, int]]:
        """(in, out) of each SDF layer; a layer before a skip leaves room
        for the encoding."""
        dims = (self.encoding, *self.implicit_dims, 1 + self.feature)
        return [(dims[l], dims[l + 1] - (self.encoding if l + 1 in self.skip_in else 0))
                for l in range(len(dims) - 1)]

    def total_final(self) -> int:
        return self.n_samples + self.n_samples_extra + 2

    def total_proposals(self) -> int:
        return self.n_samples_eval * self.max_total_iters


# ---------------------------------------------------------------------------
# the fields
# ---------------------------------------------------------------------------


def _weight(p: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    """The effective weight of a layer: g * v / |v| by rows, or w."""
    if name + ".v" in p:
        v = p[name + ".v"]
        return p[name + ".g"][:, None] * v / torch.linalg.norm(v, dim=1, keepdim=True)
    return p[name + ".w"]


def _encode(x: torch.Tensor, multires: int, tangent: bool):
    """[x, sin(2^k x), cos(2^k x) for k < multires] and, with ``tangent``,
    its derivative along each input axis: (3, N, width)."""
    freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
    xb = x[:, None, :] * freqs[:, None]  # (N, M, 3)
    s, c = torch.sin(xb), torch.cos(xb)
    n = x.shape[0]
    emb = torch.cat([x, torch.stack([s, c], dim=-2).reshape(n, -1)], dim=-1)
    if not tangent:
        return emb, None
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    dsc = torch.stack([freqs[:, None] * c, -freqs[:, None] * s], dim=-2)  # (N, M, 2, 3)
    t_sc = (dsc[None] * eye[:, None, None, None, :]).reshape(3, n, -1)
    return emb, torch.cat([eye[:, None, :].expand(3, n, 3), t_sc], dim=-1)


def _softplus100(z):
    return F.softplus(100.0 * z, beta=1.0, threshold=40.0) / 100.0


def implicit(p, x, cfg: RefConfig, mode: str, tangent: bool, clamp: bool = True):
    """(sdf (N,), features (N, F), d sdf / d x (N, 3) or None). The
    bounding-sphere clamp min(sdf, scale (R - |x|)) where ``clamp``."""
    emb, t_emb = _encode(x, cfg.multires, tangent)
    h, t = emb, t_emb
    layers = cfg.implicit_layers()
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    for l in range(len(layers)):
        if l in cfg.skip_in:
            h = torch.cat([h, emb], dim=-1) * inv_sqrt2
            if tangent:
                t = torch.cat([t, t_emb], dim=-1) * inv_sqrt2
        w, b = _weight(p, f"implicit.lin{l}"), p[f"implicit.lin{l}.b"]
        last = l == len(layers) - 1
        z = linear(h, w, b, mode)
        if tangent:
            t = _q(t, mode) @ _q(w[:1] if last else w, mode).T
        if last:
            h = z
        else:
            if tangent:
                t = t * torch.sigmoid(100.0 * z)[None]
            h = _softplus100(z)
    sdf, feats = h[:, 0], h[:, 1:]
    grad = t[..., 0].T if tangent else None
    if clamp:
        norm = torch.linalg.norm(x, dim=-1)
        sphere = cfg.sphere_scale * (cfg.bound_sphere - norm)
        inside = sdf <= sphere
        if tangent:
            g_sphere = -cfg.sphere_scale * x / norm[:, None]
            grad = torch.where(inside[:, None], grad, g_sphere)
        sdf = torch.where(inside, sdf, sphere)
    return sdf, feats, grad


def _head(p, prefix: str, n_layers: int, x, mode: str):
    h = x
    for l in range(n_layers):
        h = linear(h, _weight(p, f"{prefix}.lin{l}"), p[f"{prefix}.lin{l}.b"], mode)
        if l < n_layers - 1:
            h = torch.relu(h)
    return h


def field_block(p, cfg: RefConfig, mode: str, x, d):
    """The main field pass at (N, 3) points with view directions: (sdf,
    d sdf / d x, rgb (N, 3), lines (N, 2, 3))."""
    sdf, feats, grad = implicit(p, x, cfg, mode, tangent=True)
    dirs = _encode(d, cfg.render_multires_view, False)[0] if cfg.render_multires_view > 0 else d
    rgb = torch.sigmoid(_head(p, "rendering", len(cfg.render_dims) + 1,
                              torch.cat([x, dirs, grad, feats], dim=-1), mode))
    off = _head(p, "attraction", len(cfg.attraction_dims) + 1, torch.cat([x, d, grad, feats], dim=-1), mode)
    return sdf, grad, rgb, x[:, None, :] + off.reshape(-1, 2, 3)


def field_pass(p, cfg: RefConfig, mode: str, x, d):
    """``field_block`` over blocks of FIELD_BLOCK points, each recomputed in
    the backward (checkpointed) so the whole pass fits on the card."""
    outs = []
    for i in range(0, x.shape[0], FIELD_BLOCK):
        xs, ds = x[i:i + FIELD_BLOCK], d[i:i + FIELD_BLOCK]
        if torch.is_grad_enabled():
            outs.append(checkpoint(lambda a, b: field_block(p, cfg, mode, a, b), xs, ds, use_reentrant=False))
        else:
            outs.append(field_block(p, cfg, mode, xs, ds))
    return [torch.cat(parts) for parts in zip(*outs)]


def global_junctions(p, cfg: RefConfig, mode: str):
    h = p["junctions.latents"]
    for i in range(cfg.junction_layers + 1):
        h = linear(h, p[f"junctions.ffn.lin{i}.w"], p[f"junctions.ffn.lin{i}.b"], mode)
        if i != cfg.junction_layers:
            h = torch.relu(h)
    return h


# ---------------------------------------------------------------------------
# cameras, density, rendering
# ---------------------------------------------------------------------------


def camera_rays(uv, pose, k):
    """(unit ray directions (N, 3), camera centre (3,)) of pixels uv."""
    fx, fy, cx, cy, sk = k[0, 0], k[1, 1], k[0, 2], k[1, 2], k[0, 1]
    x, y = uv[:, 0], uv[:, 1]
    cam = torch.stack([(x - cx + cy * sk / fy - sk * y / fy) / fx, (y - cy) / fy, torch.ones_like(x),
                       torch.ones_like(x)], dim=-1)
    world = (pose @ cam.T).T[:, :3]
    d = world - pose[:3, 3]
    return d / torch.linalg.norm(d, dim=-1, keepdim=True), pose[:3, 3]


def project(k, r, t, pts):
    """Perspective projection of (..., 3) points, the near-zero depths
    nudged by +-1e-8."""
    flat = pts.reshape(-1, 3)
    x = (k @ (r @ flat.T + t[:, None])).T
    den = x[:, -1:]
    sign = torch.where(den >= 0, 1.0, -1.0).to(x.dtype)
    eps = torch.where(torch.abs(den) < 1e-8, 1e-8, 0.0).to(x.dtype)
    return (x / (den + eps * sign))[:, :2].reshape(*pts.shape[:-1], 2)


def laplace(sdf, beta):
    return (1.0 / beta) * (0.5 + 0.5 * torch.sign(sdf) * torch.expm1(-torch.abs(sdf) / beta))


def alpha_transmittance(z, density):
    dists = z[..., 1:] - z[..., :-1]
    fe = torch.cat([dists, torch.full_like(dists[..., :1], _INF_DIST)], dim=-1) * density
    shifted = torch.cat([torch.zeros_like(fe[..., :1]), fe[..., :-1]], dim=-1)
    return 1.0 - torch.exp(-fe), torch.exp(-torch.cumsum(shifted, dim=-1))


# ---------------------------------------------------------------------------
# the error-bounded sampler (VolSDF Algorithm 1, the static schedule)
# ---------------------------------------------------------------------------


def _invert_cdf(bins, cdf, u):
    s = cdf.shape[-1]
    above = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = above - 1
    above = above.clamp(max=s - 1)
    cb, ca = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    bb, ba = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    den = ca - cb
    den = torch.where(den < 1e-5, torch.ones_like(den), den)
    return bb + (u - cb) / den * (ba - bb)


def _d_star(z, sdf):
    a = z[..., 1:] - z[..., :-1]
    b, c = torch.abs(sdf[..., :-1]), torch.abs(sdf[..., 1:])
    first = a**2 + b**2 <= c**2
    second = a**2 + c**2 <= b**2
    s = (a + b + c) / 2.0
    heron = 2.0 * torch.sqrt(torch.clamp(s * (s - a) * (s - b) * (s - c), min=0.0)) / torch.clamp(a, min=1e-12)
    d = torch.zeros_like(a)
    d = torch.where(first, b, d)
    d = torch.where(second, c, d)
    d = torch.where(~first & ~second & (b + c - a > 0), heron, d)
    same = torch.sign(sdf[..., 1:]) * torch.sign(sdf[..., :-1]) == 1
    return torch.where(same, d, torch.zeros_like(d))


def _error_bound(beta, sdf, dists, d_star):
    density = laplace(sdf, beta)
    fe = dists * density[..., :-1]
    integral = torch.cumsum(torch.cat([torch.zeros_like(fe[..., :1]), fe], dim=-1), dim=-1)
    err = torch.cumsum(torch.exp(-d_star / beta) * dists**2 / (4.0 * beta**2), dim=-1)
    return torch.max((torch.clamp(torch.exp(err), max=1e6) - 1.0) * torch.exp(-integral[..., :-1]), dim=-1).values


@torch.no_grad()
def sdf_values(p, cfg: RefConfig, mode: str, pts):
    """The clamped SDF at (N, 3) points, in blocks."""
    return torch.cat([implicit(p, pts[i:i + SAMPLER_BLOCK], cfg, mode, tangent=False)[0]
                      for i in range(0, pts.shape[0], SAMPLER_BLOCK)])


@torch.no_grad()
def sample_depths(p, cfg: RefConfig, mode: str, dirs, cam, noise, taps: Optional[list] = None):
    """(z values (R, n_samples + n_extra + 2), the eikonal depth (R, 1));
    ``taps`` gets each proposal evaluation's (points, SDF) appended."""
    n = dirs.shape[0]
    kw = dict(dtype=dirs.dtype, device=dirs.device)
    beta0 = torch.abs(p["density.beta"]) + cfg.beta_min
    far = 2.0 * cfg.bound_sphere

    def sdf_at(z):
        pts = (cam[None, None, :] + z[..., None] * dirs[:, None, :]).reshape(-1, 3)
        sdf = sdf_values(p, cfg, mode, pts)
        if taps is not None:
            taps.append((pts, sdf))
        return sdf.reshape(z.shape)

    t = torch.linspace(0.0, 1.0, cfg.n_samples_eval, **kw)
    z = torch.zeros((n, 1), **kw) * (1.0 - t) + far * t
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    upper = torch.cat([mids, z[..., -1:]], dim=-1)
    lower = torch.cat([z[..., :1], mids], dim=-1)
    z = lower + (upper - lower) * noise["strat"]
    sdf = sdf_at(z)
    beta = torch.sqrt((1.0 / (4.0 * math.log(cfg.sampler_eps + 1.0))) * torch.sum((z[..., 1:] - z[..., :-1]) ** 2, -1))
    u_lin = torch.linspace(0.0, 1.0, cfg.n_samples_eval, **kw).expand(n, -1)
    weights = None
    for it in range(cfg.max_total_iters):
        dists = z[..., 1:] - z[..., :-1]
        d_star = _d_star(z, sdf)
        beta = torch.where(_error_bound(beta0, sdf, dists, d_star) <= cfg.sampler_eps, beta0, beta)
        lo, hi = beta0.expand(n), beta
        for _ in range(cfg.beta_iters):
            mid = 0.5 * (lo + hi)
            ok = _error_bound(mid[:, None], sdf, dists, d_star) <= cfg.sampler_eps
            hi = torch.where(ok, mid, hi)
            lo = torch.where(ok, lo, mid)
        beta = hi
        alpha, trans = alpha_transmittance(z, laplace(sdf, beta[:, None]))
        weights = alpha * trans
        if it < cfg.max_total_iters - 1:
            err = torch.cumsum(torch.exp(-d_star / beta[:, None]) * dists**2 / (4.0 * beta[:, None] ** 2), dim=-1)
            pdf = (torch.clamp(torch.exp(err), max=1e6) - 1.0) * trans[..., :-1]
            cdf = torch.cumsum(pdf / torch.sum(pdf, dim=-1, keepdim=True), dim=-1)
            cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
            new_z = _invert_cdf(z, cdf, u_lin)
            z, order = torch.sort(torch.cat([z, new_z], dim=-1), dim=-1, stable=True)
            sdf = torch.gather(torch.cat([sdf, sdf_at(new_z)], dim=-1), -1, order)
    w = weights[..., :-1] + 1e-5
    cdf = torch.cumsum(w / torch.sum(w, dim=-1, keepdim=True), dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    z_samples = _invert_cdf(z, cdf, noise["final_u"])
    extra = [torch.zeros((n, 1), **kw), torch.full((n, 1), far, **kw)]
    if cfg.n_samples_extra > 0:
        extra.append(z[:, noise["z_extra_idx"].long()])
    z_all = torch.sort(torch.cat([z_samples, *extra], dim=-1), dim=-1).values
    return z_all, torch.gather(z_all, -1, noise["eik_z_idx"].long())


# ---------------------------------------------------------------------------
# junction proposals and the assignment
# ---------------------------------------------------------------------------


@torch.no_grad()
def dbscan_labels(points, eps: float = 0.01, min_samples: int = 2, max_iters: int = 64):
    """DBSCAN with min_samples points in the eps ball (itself included):
    the connected components of the core points' eps graph. -> (each
    point's cluster, the lowest member's index (N for a point in none),
    whether it is a core point)."""
    n = points.shape[0]
    diff = points[:, None, :] - points[None, :, :]
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) + diff[..., 2] * diff[..., 2]
    del diff
    adj = d2 <= eps * eps
    del d2
    core = torch.sum(adj, dim=1) >= min_samples
    adj &= core[:, None] & core[None, :]
    ids = torch.arange(n, device=points.device)
    labels = torch.where(core, ids, n)
    for _ in range(max_iters):
        new = torch.minimum(labels, torch.min(torch.where(adj, labels[None, :], n), dim=1).values)
        new = torch.minimum(new, torch.where(new < n, labels[torch.clamp(new, max=n - 1)], n))
        if torch.equal(new, labels):
            break
        labels = new
    return labels, core


def cluster_means(points, labels, core):
    """The mean of each cluster's points at the row of its lowest member
    (N, 3), and which rows hold one (N,)."""
    n = points.shape[0]
    means = torch.zeros_like(points)
    counts = torch.zeros((n,), dtype=points.dtype, device=points.device)
    rep = torch.where(core, labels, 0)
    means.index_add_(0, rep, torch.where(core[:, None], points, 0.0))
    counts.index_add_(0, rep, core.to(points.dtype))
    valid = core & (labels == torch.arange(n, device=points.device))
    return means / torch.clamp(counts, min=1.0)[:, None], valid


@torch.no_grad()
def auction(cost, row_mask, col_mask, n_iters: int = 256):
    """The synchronous auction (all unassigned rows bid at once, ties to the
    lowest row), eps = spread / (rows + 1); -> (col of each row, valid)."""
    n_rows, n_cols = cost.shape
    dev, dt = cost.device, cost.dtype
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)
    benefit = -torch.where(col_mask[None, :], cost, torch.full_like(cost, _BIG))
    benefit = torch.where(row_mask[:, None], benefit, torch.full_like(cost, -_BIG))
    rows = torch.arange(n_rows, device=dev)
    live = torch.abs(benefit) < _BIG / 2
    lo = torch.min(torch.where(live, benefit, inf))
    hi = torch.max(torch.where(live, benefit, -inf))
    spread = torch.clamp(torch.where(torch.isfinite(hi - lo), hi - lo, 1.0), min=1e-6)
    lo = torch.where(torch.isfinite(lo), lo, 0.0)
    eps = spread * torch.tensor(1.0 / (n_rows + 1), dtype=dt, device=dev)
    prices = torch.zeros((n_cols,), dtype=dt, device=dev)
    owner = torch.full((n_cols,), -1, dtype=torch.int64, device=dev)
    col_of = torch.full((n_rows,), -1, dtype=torch.int64, device=dev)
    for _ in range(n_iters):
        active = row_mask & (col_of < 0)
        if not bool(torch.any(active)):
            break
        value = benefit - prices[None, :]
        best_v, best_j = torch.max(value, dim=1).values, torch.argmax(value, dim=1)
        active = active & (best_v > -_BIG / 2)
        value[rows, best_j] = -inf
        second = torch.max(value, dim=1).values
        p_best = prices[best_j]
        finite2 = torch.isfinite(second)
        bid = torch.where(finite2, p_best + (best_v - second) + eps, (best_v + p_best) - lo + eps)
        bid = torch.where(active, bid, -inf)
        bid = torch.where(~finite2 & (bid <= p_best), -inf, bid)
        col_best = torch.full((n_cols,), -float("inf"), dtype=dt, device=dev).scatter_reduce(
            0, best_j, bid, reduce="amax", include_self=True)
        achieves = active & (bid >= col_best[best_j]) & torch.isfinite(bid)
        winner = torch.full((n_cols,), n_rows, dtype=torch.int64, device=dev).scatter_reduce(
            0, best_j, torch.where(achieves, rows, n_rows), reduce="amin", include_self=True)
        won = achieves & (winner[best_j] == rows)
        taken = torch.zeros((n_cols,), dtype=torch.int64, device=dev).scatter_reduce(
            0, best_j, won.long(), reduce="amax", include_self=True).bool()
        evicted = torch.where(taken & (owner >= 0), owner, n_rows)
        col_of = torch.cat([col_of, col_of.new_full((1,), -1)]).scatter(0, evicted, -1)[:n_rows]
        owner = torch.where(taken, winner, owner)
        prices = torch.where(taken, col_best, prices)
        col_of = torch.where(won, best_j, col_of)
    safe = torch.where(col_of >= 0, col_of, 0)
    valid = row_mask & (col_of >= 0) & col_mask[safe]
    return torch.where(valid, col_of, 0), valid


def _masked_median(values, mask):
    order = torch.sort(torch.where(mask, values, torch.full_like(values, 1e30))).values
    n_valid = torch.sum(mask)
    med = order[torch.clamp(torch.div(n_valid - 1, 2, rounding_mode="floor"), min=0)]
    return torch.where(n_valid > 0, med, torch.full_like(med, 10.0))


# ---------------------------------------------------------------------------
# the step: draws, forward, loss, gradients, Adam
# ---------------------------------------------------------------------------


def step_generator(seed: int, epoch_index: int, step: int, device) -> torch.Generator:
    """The training runner's per-step generator seeding."""
    words = np.random.SeedSequence([seed, epoch_index, step]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed((int(words[0]) << 31) ^ int(words[1]))


def draw_batch(gen, scene, n_rays: int, cfg: RefConfig, width: int):
    """A view, ``n_rays`` of its support pixels with replacement, and the
    forward's noise, in the runner's order of draws; ``width`` is the
    image's."""
    dev = scene["rgb"].device
    v = int(torch.randint(0, scene["rgb"].shape[0], (), generator=gen, device=dev))
    count = scene["support_count"][v]
    draw = torch.floor(torch.rand((n_rays,), generator=gen, device=dev) * count).long()
    draw = torch.minimum(draw, count.long() - 1)
    pix = scene["support_idx"][v, draw].long()
    uv = torch.stack([(pix % width).float(), (pix // width).float()], dim=-1)
    labels = scene["labels"][v, pix].long()
    batch = {"uv": uv, "uv_proj": scene["uv_proj"][v, pix], "rgb": scene["rgb"][v, pix],
             "lines2d": scene["lines"][v, labels], "K": scene["intrinsics"][v], "pose": scene["pose"][v],
             "verts2d": scene["verts2d"][v], "verts_mask": scene["verts_mask"][v]}
    kw = dict(generator=gen, device=dev)
    bs = cfg.bound_sphere
    noise = {"eik_uniform": torch.rand((n_rays, 3), **kw) * (2 * bs) - bs,
             "strat": torch.rand((n_rays, cfg.n_samples_eval), **kw),
             "final_u": torch.rand((n_rays, cfg.n_samples), **kw),
             "eik_z_idx": torch.randint(0, cfg.total_final(), (n_rays, 1), **kw)}
    if cfg.n_samples_extra > 0:
        noise["z_extra_idx"] = torch.randperm(cfg.total_proposals(), **kw)[: cfg.n_samples_extra]
    return batch, noise


def _line_l1(lines2d, gt, weight, gate: float):
    swapped = gt[:, [2, 3, 0, 1]]
    d1 = torch.sum((lines2d - gt) ** 2, dim=-1, keepdim=True).detach()
    d2 = torch.sum((lines2d - swapped) ** 2, dim=-1, keepdim=True).detach()
    per_ray = torch.mean(torch.abs(lines2d - torch.where(d1 < d2, gt, swapped)), dim=-1)
    labels = (per_ray.detach() < gate).to(lines2d.dtype)
    return torch.sum(per_ray * weight * labels) / torch.clamp(torch.sum(labels), min=1.0), per_ray.detach()


class CannotFollow(ValueError):
    """The decisions handed in do not fit this step's shapes."""


def loss_terms(p, cfg: RefConfig, prec: Precision, batch, noise, follow: Optional[dict] = None,
               record: Optional[list] = None, stages: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """The loss and its terms for one batch. The junction stage decides
    discretely (DBSCAN's clusters, the two assignments, the gate); with
    ``follow`` (a ``record`` entry of another run: its endpoints, costs
    and decisions) it takes those decisions instead of its own: DBSCAN's
    clusters of the other run's endpoints over its own endpoints, the
    other run's assignments and gate over its own costs, and its depths;
    and it matches the junctions to the proposals that it works out itself
    from the other run's endpoints and clusters (a bf16 endpoint of its
    own would flip the sign of a near-zero L1 junction term).
    ``record`` gets this step's entry appended. ``stages`` gets this
    run's own depths and, for a recorded run, its proposal SDF evaluations
    and its field pass's inputs and outputs."""
    n = batch["uv"].shape[0]
    pose, k4 = batch["pose"], batch["K"]
    dirs, cam = camera_rays(batch["uv"], pose, k4)
    entry = {}
    taps = [] if stages is not None and record is not None else None
    own = sample_depths(p, cfg, prec.sampler, dirs, cam, noise, taps) if follow is None or stages is not None \
        else None
    z, z_eik = own if follow is None else (follow["z"], follow["z_eik"])
    if z.shape[0] != n:
        raise CannotFollow(f"the run followed has depths for {z.shape[0]} rays, this one {n}")
    entry.update(z=z, z_eik=z_eik)
    s = z.shape[-1]
    pts = cam[None, None, :] + z[..., None] * dirs[:, None, :]
    x, d = pts.reshape(-1, 3), dirs[:, None, :].expand(n, s, 3).reshape(-1, 3)
    sdf, grad, rgb, lines = field_pass(p, cfg, prec.field, x, d)
    if stages is not None:
        stages["own_z"] = own[0]
        if taps is not None:  # a recorded run's stages, for the stage checks
            stages["k1"] = taps
            stages["field"] = tuple(t.detach() for t in (x, d, sdf, grad, rgb, lines))
    beta = torch.abs(p["density.beta"]) + cfg.beta_min
    alpha, trans = alpha_transmittance(z, laplace(sdf.reshape(n, s), beta))
    weights = alpha * trans
    rgb_values = torch.sum(weights[..., None] * rgb.reshape(n, s, 3), dim=1)
    lines3d = torch.sum(weights.detach()[..., None, None] * lines.reshape(n, s, 2, 3), dim=1)

    w2c = torch.linalg.inv(pose)
    rot, trans3 = w2c[:3, :3], w2c[:3, 3]
    k3 = k4[:3, :3]
    eye3 = torch.eye(3, dtype=k3.dtype, device=k3.device)
    lines2d = project(k3, rot, trans3, lines3d.detach())
    lines2d_calib = project(eye3, rot, trans3, lines3d)
    j3d_global = global_junctions(p, cfg, prec.other)

    endpoints = lines3d.detach().reshape(-1, 3)
    if follow is not None and follow["endpoints"].shape != endpoints.shape:
        raise CannotFollow(f"the run followed has {tuple(follow['endpoints'].shape)} endpoints, this one "
                           f"{tuple(endpoints.shape)}")
    entry.update(endpoints=endpoints)
    if cfg.dbscan:
        proposals, prop_mask = cluster_means(endpoints, *dbscan_labels(
            endpoints if follow is None else follow["points"]))
        entry.update(points=endpoints, proposals=proposals, dbscan_valid=prop_mask)
    else:
        proposals, prop_mask = endpoints, torch.ones(endpoints.shape[0], dtype=torch.bool, device=endpoints.device)
    if follow is not None:
        # the proposals of the other run's endpoints, on its clusters; and,
        # for the check of that run's projections by themselves, the first
        # assignment's cost and the matched junctions' calibrated projection
        # worked out from its own proposals and matched junctions
        followed = follow["endpoints"]
        if cfg.dbscan:
            followed, _ = cluster_means(followed, *dbscan_labels(follow["points"]))
        theirs = follow.get("proposals", follow["endpoints"])
        entry["cost1_of_followed"] = torch.sqrt(torch.sum(
            (project(k3, rot, trans3, theirs)[None] - batch["verts2d"][:, None]) ** 2, dim=-1) + 1e-12)
        entry["j2d_calib_of_followed"] = project(eye3, rot, trans3, follow["j3d_local"])
    j2d = project(k3, rot, trans3, proposals)
    j2d_calib = project(eye3, rot, trans3, proposals)
    jcost = torch.sqrt(torch.sum((j2d[None] - batch["verts2d"][:, None]) ** 2, dim=-1) + 1e-12)
    rows1 = batch["verts_mask"].bool()
    if follow is None:
        col, valid = auction(jcost, rows1, prop_mask)
    else:
        if follow["cost1"].shape != jcost.shape:
            raise CannotFollow(f"the run followed has a {tuple(follow['cost1'].shape)} assignment, this one "
                               f"{tuple(jcost.shape)}")
        col, valid = follow["col1"].long(), follow["valid1"]
    entry.update(cost1=jcost, rows1=rows1, cols1=prop_mask, col1=col, valid1=valid)
    assigned = torch.gather(jcost, 1, col[:, None])[:, 0]
    correct = assigned < (_masked_median(assigned, valid) if cfg.use_median else 10.0)
    keep = valid & correct if follow is None else follow["keep"]

    eik_near = cam[None, :] + z_eik * dirs
    _, _, grad_theta = implicit(p, torch.cat([noise["eik_uniform"], eik_near], dim=0), cfg, prec.other,
                                tangent=True, clamp=False)

    rgb_loss = torch.mean(torch.abs(rgb_values - batch["rgb"]))
    eikonal_loss = torch.mean((torch.linalg.norm(grad_theta, dim=-1) - 1.0) ** 2)
    gt5 = batch["lines2d"]
    gt, lw = gt5[:, :4], gt5[:, 4]
    l2d, per_ray = _line_l1(lines2d.reshape(-1, 4), gt, lw, cfg.line_gate_px)
    gate = (per_ray < cfg.line_gate_px).to(gt.dtype)
    pts_h = torch.cat([gt.reshape(-1, 2), torch.ones_like(gt.reshape(-1, 2)[:, :1])], dim=-1)
    calib = (torch.linalg.inv(k3) @ pts_h.T).T
    calib = (calib[:, :2] / calib[:, 2:]).reshape(-1, 4)
    line_loss, _ = _line_l1(lines2d_calib.reshape(-1, 4), calib, lw * gate, cfg.line_gate_px)

    j3d_local, j2d_local_calib = proposals[col], j2d_calib[col]
    if follow is not None:  # the matched local junctions of the other run's proposals, constants to the loss
        j3d_local, j2d_local_calib = followed[col], project(eye3, rot, trans3, followed)[col]
    j2d_global_calib = project(eye3, rot, trans3, j3d_global)
    cost = torch.sum(torch.abs(j3d_local[:, None] - j3d_global[None]), dim=-1) + cfg.junction_cost_2d_scale * torch.sum(
        torch.abs(j2d_local_calib[:, None] - j2d_global_calib[None]), dim=-1)
    cost = torch.nan_to_num(cost.detach(), nan=1e5)
    if follow is None:
        jcol, jvalid = auction(cost, keep, torch.ones(cost.shape[1], dtype=torch.bool, device=cost.device))
    else:
        jcol, jvalid = follow["col2"].long(), follow["valid2"]
    if record is not None:
        record.append(dict(entry, keep=keep, j3d_local=j3d_local, j2d_local_calib=j2d_local_calib, cost2=cost,
                           col2=jcol, valid2=jvalid))
    n_valid = torch.sum(jvalid).to(gt.dtype).clamp(min=1.0)
    j3d_loss = torch.sum(torch.where(jvalid, torch.sum(torch.abs(j3d_local - j3d_global[jcol]), dim=-1), 0.0)) / n_valid
    j2d_loss = torch.sum(torch.where(
        jvalid, torch.sum(torch.abs(j2d_local_calib - j2d_global_calib[jcol]), dim=-1), 0.0)) / n_valid

    loss = (rgb_loss + cfg.eikonal_weight * eikonal_loss + cfg.line_weight * line_loss
            + cfg.junction_3d_weight * j3d_loss + cfg.junction_2d_weight * j2d_loss)
    return {"loss": loss, "rgb_loss": rgb_loss, "eikonal_loss": eikonal_loss, "line_loss": line_loss,
            "l2d_loss": l2d, "j3d_loss": j3d_loss, "j2d_loss": j2d_loss}


@torch.no_grad()
def adam(p, grads, mu, nu, count: int, lr: float):
    """optax's Adam, in place; ``count`` is the update's number (1-based)."""
    c1, c2 = 1.0 - B1**count, 1.0 - B2**count
    for name in p:
        g = grads[name]
        mu[name].mul_(B1).add_((1.0 - B1) * g)
        nu[name].mul_(B2).add_((1.0 - B2) * g * g)
        p[name].add_(-lr * (mu[name] / c1) / (torch.sqrt(nu[name] / c2) + ADAM_EPS))


def run_steps(weights: Dict[str, torch.Tensor], scene, width: int, cfg: RefConfig, n_rays: int, seed: int,
              n_steps: int, decay_steps: int, prec: Precision = F32, follow: Optional[list] = None,
              record: Optional[list] = None, stages: Optional[dict] = None):
    """``n_steps`` training steps from ``weights`` (not modified) on the
    runner's generators for steps 0 .. n_steps - 1, each step's junction
    decisions taken from ``follow[i]`` where given and appended to
    ``record``; ``stages`` gets the first step's (``loss_terms``). ->
    (each step's loss terms as floats, the first step's gradients, the
    parameters after the last step)."""
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = prec.other == "tf32"
    try:
        p = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
        mu = {k: torch.zeros_like(v) for k, v in p.items()}
        nu = {k: torch.zeros_like(v) for k, v in p.items()}
        losses, first_grads = [], None
        dev = scene["rgb"].device
        for i in range(n_steps):
            batch, noise = draw_batch(step_generator(seed, 0, i, dev), scene, n_rays, cfg, width)
            terms = loss_terms(p, cfg, prec, batch, noise, None if follow is None else follow[i], record,
                               stages if i == 0 else None)
            names = list(p)
            gs = torch.autograd.grad(terms["loss"], [p[k] for k in names], allow_unused=True)
            grads = {k: torch.zeros_like(p[k]) if g is None else g for k, g in zip(names, gs)}
            if first_grads is None:
                first_grads = {k: g.detach().clone() for k, g in grads.items()}
            lr = cfg.learning_rate * cfg.decay_rate ** (i / max(decay_steps, 1))
            adam(p, grads, mu, nu, i + 1, lr)
            losses.append({k: float(v.detach()) for k, v in terms.items()})
            del terms, gs, grads
        return losses, first_grads, {k: v.detach() for k, v in p.items()}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
