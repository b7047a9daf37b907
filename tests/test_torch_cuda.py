"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips when no CUDA device is present (decided
inside the fixture, never at import). Run on a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances, of each output's own largest entry (so zeros or a flipped sign
score 1 or 2): f32 1e-3 — the kernels sum in another order than cuBLAS;
bf16 3e-2 — also the rare activation whose f32 sum rounds to the
neighbouring bf16 value. K3-bwd re-runs its forward, so against autograd
of ``field_math`` a relu that an f32 sum in another order moves across 0
changes a point's whole backward: it is held entrywise (1e-6) against
K2-fwd + K2-bwd, which share its tile bodies, and in relative L2 norm (f32
5e-3, bf16 0.15) against autograd. K4: rays whose beta differs (one flipped
``err <= eps`` decision) may be 0.5% of the rays; the others agree to rtol
2e-4 / atol 2e-5.
"""

import pytest
import torch

from neat_tpu_torch.model.neat import init_neat
from neat_tpu_torch.ops import fused_field as F
from neat_tpu_torch.ops import fused_field_stash as K
from neat_tpu_torch.ops import fused_round as R
from neat_tpu_torch.ops.fused_field import _flatten_eff
from neat_tpu_torch.ops.fused_sdf import (
    _effective_weights, fused_sdf_kernel, fused_sdf_kernel_variant, fused_sdf_plain,
)
from neat_tpu_torch.core.embedder import positional_encoding
from neat_tpu_torch.utils.benchscene import bench_config, bench_scene, bench_step

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-3, torch.bfloat16: 3e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(scope="module")
def setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = bench_config("bfloat16", device="cuda")
    return cfg, init_neat(cfg, seed=0, device="cuda")


def _err(a, b):
    return float((a.float() - b.float()).abs().max()) / max(1e-12, float(b.float().abs().max()))


@pytest.mark.parametrize("n_points", [1, 127, 129, 1000])  # ragged against the 32- and 128-point tiles
@pytest.mark.parametrize("cd", DTYPES)
def test_k1_kernel_matches_plain(setup, cd, n_points):
    cfg, model = setup
    pts = (torch.rand((n_points, 3), device="cuda") * 2 - 1) * 3.0
    with torch.no_grad():
        emb = positional_encoding(pts, 6).to(cd).contiguous()
        ws, bs = _effective_weights(model.implicit, cfg.implicit, cd)
        ws = [w.contiguous() for w in ws]
        ref = fused_sdf_plain(emb, ws, bs)
        got = fused_sdf_kernel(emb, ws, bs)
        assert got.shape == (n_points,) and bool(torch.isfinite(got).all())
        assert _err(got, ref) < TOL[cd]
        if cd == torch.bfloat16:  # the scalar kernel and the tensor-core variants, same inputs
            for variant in ("scalar", "wgmma_exact", "mma_sync"):
                assert _err(fused_sdf_kernel_variant(emb, ws, bs, variant), ref) < TOL[cd]


@pytest.mark.parametrize("cd", DTYPES)
def test_k2_kernels_match_plain(setup, cd):
    cfg, model = setup
    icfg, rcfg = cfg.implicit, cfg.rendering
    n = 1000
    x = (torch.rand((n, 3), device="cuda") * 2 - 1) * 1.5
    x[:100] *= 3.2 / torch.linalg.norm(x[:100], dim=-1, keepdim=True)
    d = torch.nn.functional.normalize(torch.randn((n, 3), device="cuda"), dim=-1)
    cots = tuple(torch.randn((n, w), device="cuda") for w in (1, 3, 3, 6))
    with torch.no_grad():
        flat = tuple(w.detach().contiguous() for w in _flatten_eff(model))
        got = K.field_fwd_stash_kernel(flat, x, d, icfg, cd)
        out, res = K.field_fwd_res(flat, x, d, icfg, rcfg, cd)
        ref = (*out, *K._pack_res(res))
        for a, b in zip(got, ref):
            assert _err(a, b) < TOL[cd]
        scd, sf32 = (r.contiguous() for r in ref[4:])
        rgb, grads = out[2].contiguous(), out[1].contiguous()
        deff, dx, dd = K.field_bwd_stash_kernel(flat, x, d, scd, sf32, rgb, grads, cots, icfg, cd)
        res = K._unpack_res(scd, sf32, rgb, grads, icfg, rcfg)
        deff_p, dx_p, dd_p = K.field_bwd_stashed(flat, x, d, res, cots, icfg, rcfg, cd)
    assert _err(dx, dx_p) < TOL[cd] and _err(dd, dd_p) < TOL[cd]
    for a, b in zip(deff, deff_p):
        assert _err(a, b) < TOL[cd]


def _field_inputs(n):
    x = (torch.rand((n, 3), device="cuda") * 2 - 1) * 1.5
    x[: n // 10] *= 3.2 / torch.linalg.norm(x[: n // 10], dim=-1, keepdim=True)
    d = torch.nn.functional.normalize(torch.randn((n, 3), device="cuda"), dim=-1)
    return x, d, tuple(torch.randn((n, w), device="cuda") for w in (1, 3, 3, 6))


@pytest.mark.parametrize("cd", DTYPES)
def test_k3_kernels_match_plain_and_k2(setup, cd):
    cfg, model = setup
    icfg, rcfg = cfg.implicit, cfg.rendering
    x, d, cots = _field_inputs(1000)
    flat = tuple(w.detach().contiguous() for w in _flatten_eff(model))
    with torch.no_grad():
        got = F.field_fwd_kernel(flat, x, d, icfg, cd)
        ref = F.field_math(flat, x, d, icfg, rcfg, cd)
        k2 = K.field_fwd_stash_kernel(flat, x, d, icfg, cd)
        deff, dx, dd = F.field_bwd_kernel(flat, x, d, cots, icfg, cd)
        # K3-bwd re-runs the scalar forward tile: K2-bwd replays the scalar K2-fwd's stash
        k2s = K.field_fwd_stash_kernel_variant(flat, x, d, icfg, cd, "scalar") if cd == torch.bfloat16 else k2
        deff2, dx2, dd2 = K.field_bwd_stash_kernel(flat, x, d, k2s[4], k2s[5], k2s[2], k2s[1], cots, icfg, cd)
    fwd_tol = 1e-5 if cd == torch.float32 else 3e-2
    for a, b, c in zip(got, ref, k2):
        assert _err(a, b) < fwd_tol and _err(a, c) <= 1e-6
    for a, b in zip((*deff, dx, dd), (*deff2, dx2, dd2)):
        assert _err(a, b) <= 1e-6
    leaves = [w.clone().requires_grad_(True) for w in (*flat, x, d)]
    plain = torch.autograd.grad(F.field_math(leaves[:-2], leaves[-2], leaves[-1], icfg, rcfg, cd), leaves, cots)
    l2_tol = 5e-3 if cd == torch.float32 else 0.15
    for a, b in zip((*deff, dx, dd), plain):
        assert float((a - b).norm()) <= l2_tol * float(b.norm())


@pytest.mark.parametrize("n_points", [1, 127, 129, 1000])  # ragged against the 128-point tile
def test_tensor_core_field_forwards_match_plain(setup, n_points, capsys):
    """bf16 K2-fwd and K3-fwd (the tensor-core kernel) and their scalar
    variants against the plain versions; K3-fwd equals K2-fwd (same code).
    Stash entries more than one bf16 step off are reported."""
    cfg, model = setup
    icfg, rcfg = cfg.implicit, cfg.rendering
    cd = torch.bfloat16
    x, d, _ = _field_inputs(n_points)
    flat = tuple(w.detach().contiguous() for w in _flatten_eff(model))
    with torch.no_grad():
        out, res = K.field_fwd_res(flat, x, d, icfg, rcfg, cd)
        ref = (*out, *K._pack_res(res))
        got = K.field_fwd_stash_kernel(flat, x, d, icfg, cd)
        scalar = K.field_fwd_stash_kernel_variant(flat, x, d, icfg, cd, "scalar")
        k3 = F.field_fwd_kernel(flat, x, d, icfg, cd)
        k3_ref = F.field_math(flat, x, d, icfg, rcfg, cd)
        k3_scalar = F.field_fwd_kernel_variant(flat, x, d, icfg, cd, "scalar")
    for a, s, b in zip(got, scalar, ref):
        assert a.shape == b.shape and bool(torch.isfinite(a.float()).all())
        assert _err(a, b) < TOL[cd] and _err(s, b) < TOL[cd]
    for a, s, b, c in zip(k3, k3_scalar, k3_ref, got):
        assert _err(a, b) < TOL[cd] and _err(s, b) < TOL[cd]
        assert torch.equal(a, c)
    with capsys.disabled():
        for name, a, b in zip(("stash_cd", "stash_f32"), got[4:], ref[4:]):
            a, b = a.float(), b.float()
            step = torch.exp2(torch.floor(torch.log2(b.abs().clamp_min(2.0 ** -126))) - 7)
            print(f"\nn={n_points} {name}: {int(((a - b).abs() > step).sum())} of {b.numel()} "
                  "entries more than one bf16 step off")


@pytest.mark.parametrize("refine", [True, False])
def test_k4_kernel_matches_plain(setup, refine):
    rays, lanes = 256, 384
    z = torch.sort(torch.rand((rays, lanes), device="cuda") * 6.0, dim=-1).values
    sdf = (z - 3.0).abs() - 1.5 + 0.3 * torch.randn((rays, lanes), device="cuda")
    beta = torch.rand((rays,), device="cuda") * 0.45 + 0.05
    beta0 = torch.tensor([2.1e-3], device="cuda")
    args = (0.1, 10, 0.0, refine)
    bk, wk, pk = R.fused_round_kernel(z, sdf, beta, beta0, *args)
    bp, wp, pp = R.fused_round_plain(z, sdf, beta, beta0[0], *args)
    keep = (bk - bp).abs() <= 2e-4 * bp.abs()
    assert int((~keep).sum()) <= 0.005 * rays
    assert torch.allclose(wk[keep], wp[keep], rtol=2e-4, atol=2e-5)
    assert torch.allclose(pk[keep], pp[keep], rtol=2e-4, atol=2e-5, equal_nan=True)
    assert bool((pk[:, -1] == 0).all()) and (refine or bool((pk == 0).all()))


@pytest.mark.parametrize(
    "kwargs,expected",
    [
        (dict(), dict(sdf=5, fwd_stash=1, bwd_stash=1)),
        (dict(field="recompute"), dict(sdf=5, fwd=1, bwd=1)),
        (dict(fused_rounds="on"), dict(round=5, sdf=5, fwd_stash=1, bwd_stash=1)),
    ],
)
def test_training_step_launches_its_kernels(setup, kwargs, expected):
    # the bf16 step's K2-fwd and K3-fwd launch the tensor-core forward;
    # the counters stay on the wrappers the model calls
    cfg = bench_config("bfloat16", device="cuda", **kwargs)
    scene = bench_scene(cfg, device="cuda")
    step, state = bench_step(cfg, device="cuda", n_rays=128)
    fns = dict(sdf=fused_sdf_kernel, fwd_stash=K.field_fwd_stash_kernel, bwd_stash=K.field_bwd_stash_kernel,
               fwd=F.field_fwd_kernel, bwd=F.field_bwd_kernel, round=R.fused_round_kernel)
    before = {k: f.launches for k, f in fns.items()}
    state, metrics = step(state, scene, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    assert torch.isfinite(metrics["loss"])
    assert {k: f.launches - before[k] for k, f in fns.items()} == {k: expected.get(k, 0) for k in fns}
