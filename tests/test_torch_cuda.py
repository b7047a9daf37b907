"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips when no CUDA device is present (decided
inside the fixture, never at import). Run on a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances, of each output's own largest entry (so zeros or a flipped sign
score 1 or 2): f32 1e-3 — the kernels sum in another order than cuBLAS;
bf16 3e-2 — also the rare activation whose f32 sum rounds to the
neighbouring bf16 value. K3-bwd re-runs its forward, so against autograd
of ``field_math`` a relu that an f32 sum in another order moves across 0
changes a point's whole backward: it is held entrywise against K2-fwd +
K2-bwd, which run its kernels (f32 and the bf16 "scalar" variant 1e-6; the
bf16 split K3-bwd exactly in dx and dd, 1e-4 in the gradients, whose f32
sums it takes in chunks), and in relative L2 norm (f32
5e-3, bf16 0.15) against autograd; in f32 also against autograd in f64
over eight draws, in relative L2 norm off the crossings (1e-5), with every point
that is off explained by one. K4 (and its first port): rays
whose beta differs (one flipped ``err <= eps`` decision) may be 0.5% of the
rays; the others agree to rtol 2e-4 / atol 2e-5. DBSCAN: the valid rows as on
the CPU exactly, the means within 1e-6. The f32 K1 and K3-fwd
(3xTF32 on the tensor cores) are also held against the plain version in
f64: each output's max |err| at most 1.5x plain f32's and 1.5x the scalar
variant's against the same f64, or 2^-20 of the largest entry. In f32 the
recompute pair's forward is the scalar tile (K3-bwd re-runs it), held to
1e-5 of field_math and to K2-fwd.

Every test draws its inputs from its own seeded generator.
"""

import math

import pytest
import torch

from neat_tpu_torch.model.neat import init_neat
from neat_tpu_torch.ops import field_dw as DW
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


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


@pytest.mark.parametrize("n_points", [1, 127, 129, 1000])  # ragged against the 32- and 128-point tiles
@pytest.mark.parametrize("cd", DTYPES)
def test_k1_kernel_matches_plain(setup, cd, n_points):
    cfg, model = setup
    pts = (torch.rand((n_points, 3), generator=_gen(n_points), device="cuda") * 2 - 1) * 3.0
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
    x, d, cots = _field_inputs(1000, seed=0)
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


def _field_inputs(n, seed):
    """Points (a tenth of them outside the bounding sphere, where the clamp
    is active), unit directions and the four cotangents, from ``seed``."""
    gen = _gen(seed)
    x = (torch.rand((n, 3), generator=gen, device="cuda") * 2 - 1) * 1.5
    x[: n // 10] *= 3.2 / torch.linalg.norm(x[: n // 10], dim=-1, keepdim=True)
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen, device="cuda"), dim=-1)
    return x, d, tuple(torch.randn((n, w), generator=gen, device="cuda") for w in (1, 3, 3, 6))


@pytest.mark.parametrize("n_points", [1, 127, 129, 1000])  # ragged against the 32-point tile and 64-point chunk
def test_split_k2_backward_matches_scalar_and_plain(setup, n_points):
    """The split bf16 K2-bwd with the scalar row-local pass (the "split"
    variant): dx, dd and every bias gradient equal the fused scalar kernel's
    (the same tile code) and dW is within the bf16 tolerance of the plain
    version; the row-local pass's workspace is within it of the plain
    row-local pass's; the GEMM is within 1e-4 of field_dw_plain on the
    producer's own workspace, and bit-equal from one call to the next."""
    cfg, model = setup
    icfg, rcfg = cfg.implicit, cfg.rendering
    cd = torch.bfloat16
    x, d, cots = _field_inputs(n_points, seed=n_points)
    with torch.no_grad():
        flat = tuple(w.detach().contiguous() for w in _flatten_eff(model))
        out, res = K.field_fwd_res(flat, x, d, icfg, rcfg, cd)
        scd, sf32 = (r.contiguous() for r in K._pack_res(res))
        rgb, grads = out[2].contiguous(), out[1].contiguous()
        args = (flat, x, d, scd, sf32, rgb, grads, cots, icfg)
        deff, dx, dd = K.field_bwd_stash_kernel_variant(*args, cd, "split")
        deff_s, dx_s, dd_s = K.field_bwd_stash_kernel_variant(*args, cd, "scalar")
        deff_p, dx_p, dd_p = K.field_bwd_stashed(flat, x, d, res, cots, icfg, rcfg, cd)
        _, _, _, ws = K.field_bwd_rowlocal_kernel(*args, variant="split")
        ws_p = K.field_bwd_rowlocal_plain(flat, x, d, res, cots, icfg, rcfg, cd)[0]
        dws = [torch.zeros(F._n_param_grads(), device="cuda") for _ in range(2)]
        for g in dws:
            DW.field_dw_kernel(ws, n_points, g)
        plain = DW.field_dw_plain(ws)
    assert torch.equal(dx, dx_s) and torch.equal(dd, dd_s)
    assert _err(dx, dx_p) < TOL[cd] and _err(dd, dd_p) < TOL[cd]
    for l in range(19):
        assert torch.equal(deff[2 * l + 1], deff_s[2 * l + 1])
        assert _err(deff[2 * l], deff_p[2 * l]) < TOL[cd]
    ops, ops_p = DW.unpack_workspace(ws, n_points), DW.unpack_workspace(ws_p, n_points)
    for key in ops:
        assert _err(ops[key], ops_p[key]) < TOL[cd], key
    assert not ws[:, n_points:].any()
    assert torch.equal(dws[0], dws[1])
    for a, b in zip(K._split_param_grads(dws[0], flat)[0::2], plain):
        assert _err(a, b) < 1e-4


@pytest.mark.parametrize("n_points", [1, 63, 65, 1000])  # ragged against the 64-point tile
def test_mma_row_local_pass_matches_split_and_plain(setup, n_points):
    """The tensor-core row-local pass ("mma"): its workspace within the bf16
    tolerance of the plain row-local pass's (padded points zero), its dx, dd
    and bias gradients within it of the scalar pass's ("split"), and K2-bwd
    with it (the GEMM on its workspace) within it of the plain version."""
    cfg, model = setup
    icfg, rcfg = cfg.implicit, cfg.rendering
    cd = torch.bfloat16
    x, d, cots = _field_inputs(n_points, seed=1000 + n_points)
    with torch.no_grad():
        flat = tuple(w.detach().contiguous() for w in _flatten_eff(model))
        out, res = K.field_fwd_res(flat, x, d, icfg, rcfg, cd)
        scd, sf32 = (r.contiguous() for r in K._pack_res(res))
        rgb, grads = out[2].contiguous(), out[1].contiguous()
        args = (flat, x, d, scd, sf32, rgb, grads, cots, icfg)
        dp_m, dx_m, dd_m, ws_m = K.field_bwd_rowlocal_kernel(*args, variant="mma")
        dp_s, dx_s, dd_s, _ = K.field_bwd_rowlocal_kernel(*args, variant="split")
        ws_p = K.field_bwd_rowlocal_plain(flat, x, d, res, cots, icfg, rcfg, cd)[0]
        deff, dx, dd = K.field_bwd_stash_kernel(*args, cd)
        deff_p, dx_p, dd_p = K.field_bwd_stashed(flat, x, d, res, cots, icfg, rcfg, cd)
    ops, ops_p = DW.unpack_workspace(ws_m, n_points), DW.unpack_workspace(ws_p, n_points)
    for key in ops_p:
        assert _err(ops[key], ops_p[key]) < TOL[cd], key
    assert not ws_m[:, n_points:].any()
    assert _err(dx_m, dx_s) < TOL[cd] and _err(dd_m, dd_s) < TOL[cd]
    for a, b in zip(K._split_param_grads(dp_m, flat)[1::2], K._split_param_grads(dp_s, flat)[1::2]):
        assert _err(a, b) < TOL[cd]
    for a, b in zip((*deff, dx, dd), (*deff_p, dx_p, dd_p)):
        assert _err(a, b) < TOL[cd]


def test_mma_row_local_pass_past_2_31_workspace_elements(setup):
    """At 2^31 // WS_ROWS + 1000 points (168,093) the workspace holds more
    than 2^31 elements, so its last rows lie past a 32-bit offset: the
    tensor-core row-local pass (on K2-fwd's stash) writes every operand
    within the bf16 tolerance of the scalar pass's ("split"), and its dx, dd
    and bias gradients, and the model's K2-bwd with it, agree with the
    "split" ones as closely."""
    cfg, model = setup
    icfg, cd = cfg.implicit, torch.bfloat16
    n_points = 2**31 // DW.WS_ROWS + 1000
    assert DW.WS_ROWS * DW.ws_points(n_points) > 2**31
    x, d, cots = _field_inputs(n_points, seed=7)
    flat = tuple(w.detach().contiguous() for w in _flatten_eff(model))
    with torch.no_grad():
        sdf, grads, rgb, att, scd, sf32 = K.field_fwd_stash_kernel(flat, x, d, icfg, cd)
        args = (flat, x, d, scd, sf32, rgb, grads, cots, icfg)
        dp_m, dx_m, dd_m, ws_m = K.field_bwd_rowlocal_kernel(*args)
        dp_s, dx_s, dd_s, ws_s = K.field_bwd_rowlocal_kernel(*args, variant="split")
        ops, ops_s = DW.unpack_workspace(ws_m, n_points), DW.unpack_workspace(ws_s, n_points)
        for key in ops_s:
            assert _err(ops[key], ops_s[key]) < TOL[cd], key
        assert not ws_m[:, n_points:].any()
        del ops, ops_s, ws_m, ws_s
        assert _err(dx_m, dx_s) < TOL[cd] and _err(dd_m, dd_s) < TOL[cd]
        for a, b in zip(K._split_param_grads(dp_m, flat)[1::2], K._split_param_grads(dp_s, flat)[1::2]):
            assert _err(a, b) < TOL[cd]
        got = K.field_bwd_stash_kernel(*args, cd)
        want = K.field_bwd_stash_kernel_variant(*args, cd, "split")
    for a, b in zip((*got[0], got[1], got[2]), (*want[0], want[1], want[2])):
        assert _err(a, b) < TOL[cd]


@pytest.mark.parametrize("cd", DTYPES)
def test_k3_kernels_match_plain_and_k2(setup, cd):
    """K3 against the K2 pair on the same inputs. f32: K3-bwd, the scalar
    kernel, equals K2-fwd + K2-bwd (one tile body) within 1e-6. bf16: K3-bwd,
    the split backward over chunks, equals the model's K2 (K2-fwd, then the
    split K2-bwd on its stash) in dx and dd exactly and in the gradients
    within 1e-4 (the same products, summed in chunks); its "scalar" variant
    equals the scalar K2 pair within 1e-6."""
    cfg, model = setup
    icfg, rcfg = cfg.implicit, cfg.rendering
    x, d, cots = _field_inputs(1000, seed=0)
    flat = tuple(w.detach().contiguous() for w in _flatten_eff(model))
    with torch.no_grad():
        # the pair's forward: in f32 the scalar tile, which K3-bwd re-runs
        got = F.field_fwd_kernel(flat, x, d, icfg, cd, pair=True)
        ref = F.field_math(flat, x, d, icfg, rcfg, cd)
        k2 = K.field_fwd_stash_kernel(flat, x, d, icfg, cd)
        deff, dx, dd = F.field_bwd_kernel(flat, x, d, cots, icfg, cd)
        deff2, dx2, dd2 = K.field_bwd_stash_kernel(flat, x, d, k2[4], k2[5], k2[2], k2[1], cots, icfg, cd)
        if cd == torch.bfloat16:
            # the scalar K3-bwd re-runs the scalar forward tile and the fused
            # scalar backward tile: the fused scalar K2-bwd replays the scalar
            # K2-fwd's stash
            k2s = K.field_fwd_stash_kernel_variant(flat, x, d, icfg, cd, "scalar")
            scalar2 = K.field_bwd_stash_kernel_variant(
                flat, x, d, k2s[4], k2s[5], k2s[2], k2s[1], cots, icfg, cd, "scalar")
            scalar3 = F.field_bwd_kernel_variant(flat, x, d, cots, icfg, cd, "scalar")
    fwd_tol = 1e-5 if cd == torch.float32 else 3e-2
    for a, b, c in zip(got, ref, k2):
        assert _err(a, b) < fwd_tol and _err(a, c) <= 1e-6
    if cd == torch.bfloat16:
        assert torch.equal(dx, dx2) and torch.equal(dd, dd2)
        for a, b in zip(deff, deff2):
            assert _err(a, b) <= 1e-4
        for a, b in zip((*scalar3[0], scalar3[1], scalar3[2]), (*scalar2[0], scalar2[1], scalar2[2])):
            assert _err(a, b) <= 1e-6
    else:
        for a, b in zip((*deff, dx, dd), (*deff2, dx2, dd2)):
            assert _err(a, b) <= 1e-6
    leaves = [w.clone().requires_grad_(True) for w in (*flat, x, d)]
    plain = torch.autograd.grad(F.field_math(leaves[:-2], leaves[-2], leaves[-1], icfg, rcfg, cd), leaves, cots)
    l2_tol = 5e-3 if cd == torch.float32 else 0.15
    for a, b in zip((*deff, dx, dd), plain):
        assert float((a - b).norm()) <= l2_tol * float(b.norm())


@pytest.mark.parametrize("n_points", [129, F.RECOMPUTE_CHUNK + 1, 40_000])  # one, two and three chunks
def test_split_k3_backward_matches_the_models_k2_over_chunks(setup, n_points):
    """The bf16 K3-bwd over one or more chunks (the last of one point, or
    ragged): dx and dd equal the model's K2-fwd + split K2-bwd exactly, the
    gradients within 1e-4; the forward its chunks recompute equals K2-fwd's;
    each chunk launches the forward, the row-local pass and the GEMM once."""
    cfg, model = setup
    icfg, cd = cfg.implicit, torch.bfloat16
    x, d, cots = _field_inputs(n_points, seed=n_points)
    flat = tuple(w.detach().contiguous() for w in _flatten_eff(model))
    chunk_fns = (F.field_bwd_chunk_fwd, F.field_bwd_chunk_rowlocal, F.field_bwd_chunk_dw)
    seen, inner = [], F.field_bwd_chunk_fwd

    def record(*args):
        out = inner(*args)
        seen.append(out[:4])
        return out

    record.launches = 0  # the wrapper counts on its module-level name
    with torch.no_grad():
        k2 = K.field_fwd_stash_kernel(flat, x, d, icfg, cd)
        deff2, dx2, dd2 = K.field_bwd_stash_kernel(flat, x, d, k2[4], k2[5], k2[2], k2[1], cots, icfg, cd)
        before = [f.launches for f in chunk_fns]
        F.field_bwd_chunk_fwd = record
        try:
            deff, dx, dd = F.field_bwd_kernel(flat, x, d, cots, icfg, cd)
        finally:
            F.field_bwd_chunk_fwd = inner
    chunks = len(F.recompute_chunks(n_points))
    assert record.launches == chunks
    assert [f.launches - b for f, b in zip(chunk_fns[1:], before[1:])] == [chunks, chunks]
    assert len(seen) == chunks
    for a, b in zip((torch.cat(ts) for ts in zip(*seen)), k2[:4]):
        assert torch.equal(a, b)
    assert torch.equal(dx, dx2) and torch.equal(dd, dd2)
    for a, b in zip(deff, deff2):
        assert _err(a, b) <= 1e-4


def _l2(a, b):
    return float((a.double() - b.double()).norm()) / max(1e-300, float(b.double().norm()))


@pytest.mark.parametrize("seed", range(8))
def test_k3_f32_backward_is_f64_autograd_off_the_crossings(setup, seed, capsys):
    """f32 K3-bwd against autograd of ``field_math`` in f64 on the same draw.
    A crossing is a head relu or the sdf clamp whose f32 forward (K2-fwd's
    stash: K3 runs the same tile) decides on the other side of 0 than f64:
    there the point's whole backward changes. Every point whose own dx or dd
    is more than 1% of the largest entry off has a crossing; each crossing
    lies within 1e-4 of its layer's largest value of 0; on the points
    without one, all 40 outputs are within 1e-5 of f64 in relative L2 norm.
    Printed: f32 autograd against f64 and K3-bwd against f32 autograd on the
    whole draw (the check of ``test_k3_kernels_match_plain_and_k2``)."""
    cfg, model = setup
    icfg, rcfg = cfg.implicit, cfg.rendering
    f32, f64 = torch.float32, torch.float64
    x, d, cots = _field_inputs(1000, seed=seed)
    flat = tuple(w.detach().contiguous() for w in _flatten_eff(model))
    with torch.no_grad():
        k2 = K.field_fwd_stash_kernel(flat, x, d, icfg, f32)
        _, res64 = K.field_fwd_res(tuple(w.double() for w in flat), x.double(), d.double(), icfg, rcfg, f64)
    _, _, i_r, i_a, z8, _, _ = K._unpack_res(k2[4], k2[5], k2[2], k2[1], icfg, rcfg)
    _, _, i_r64, i_a64, z8_64, _, _ = res64
    crossing = torch.zeros(x.shape[0], dtype=torch.bool, device="cuda")
    margin = 0.0
    for post, post64 in zip((*i_r, *i_a), (*i_r64, *i_a64)):
        flip = (post > 0) != (post64 > 0)
        crossing |= flip.any(dim=-1)
        if flip.any():  # the pre-activation at a flip is the larger of the two posts
            margin = max(margin, float(torch.maximum(post.double(), post64)[flip].max() / post64.max()))
    gap, gap64 = z8[:, :1] - F._sphere(x, icfg)[1], z8_64[:, :1] - F._sphere(x.double(), icfg)[1]
    flip = torch.sign(gap).double() != torch.sign(gap64)
    crossing |= flip[:, 0]
    if flip.any():
        margin = max(margin, float(torch.maximum(gap.abs().double(), gap64.abs())[flip].max() / gap64.abs().max()))

    def kernel(keep):
        with torch.no_grad():
            deff, dx, dd = F.field_bwd_kernel(flat, x[keep], d[keep], tuple(c[keep] for c in cots), icfg, f32)
        return (*deff, dx, dd)

    def autograd(dtype, keep):
        leaves = [w.to(dtype).clone().requires_grad_(True) for w in (*flat, x[keep], d[keep])]
        outs = F.field_math(leaves[:-2], leaves[-2], leaves[-1], icfg, rcfg, dtype)
        return torch.autograd.grad(outs, leaves, tuple(c[keep].to(dtype) for c in cots))

    every = torch.ones_like(crossing)
    k_all, a32_all, a64_all = kernel(every), autograd(f32, every), autograd(f64, every)
    off = sum((a.double() - b).abs().amax(dim=-1) > 1e-2 * b.abs().max()
              for a, b in zip(k_all[-2:], a64_all[-2:])) > 0
    keep = ~crossing
    k_keep = max(_l2(a, b) for a, b in zip(kernel(keep), autograd(f64, keep)))
    with capsys.disabled():
        print(f"\nK3-bwd f32 seed={seed}: {int(crossing.sum())} points with a crossing (margin {margin:.3g}), "
              f"{int(off.sum())} off; without them against f64 autograd {k_keep:.3g}; whole draw: against "
              f"f64 {max(_l2(a, b) for a, b in zip(k_all, a64_all)):.3g}, f32 autograd against f64 "
              f"{max(_l2(a, b) for a, b in zip(a32_all, a64_all)):.3g}, against f32 autograd "
              f"{max(_l2(a, b) for a, b in zip(k_all, a32_all)):.3g}")
    assert not (off & keep).any()
    assert margin <= 1e-4
    assert k_keep <= 1e-5


@pytest.mark.parametrize("n_points", [1, 127, 129, 1000])  # ragged against the 128-point tile
def test_tensor_core_field_forwards_match_plain(setup, n_points, capsys):
    """bf16 K2-fwd and K3-fwd (the tensor-core kernel) and their scalar
    variants against the plain versions; K3-fwd equals K2-fwd (same code).
    Stash entries more than one bf16 step off are reported."""
    cfg, model = setup
    icfg, rcfg = cfg.implicit, cfg.rendering
    cd = torch.bfloat16
    x, d, _ = _field_inputs(n_points, seed=n_points)
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


def _f64_errors(outs, ref64):
    return [float((a.double() - r).abs().max()) for a, r in zip(outs, ref64)]


def _f32_routes(setup, kernel, n_points):
    """The f32 kernel (3xTF32), its scalar variant, the plain version in
    f32 and in f64, on inputs drawn from n_points."""
    cfg, model = setup
    icfg, rcfg = cfg.implicit, cfg.rendering
    cd = torch.float32
    with torch.no_grad():
        if kernel == "k1":
            pts = (torch.rand((n_points, 3), generator=_gen(n_points), device="cuda") * 2 - 1) * 3.0
            emb = positional_encoding(pts, 6).contiguous()
            ws, bs = _effective_weights(model.implicit, icfg, cd)
            ws = [w.contiguous() for w in ws]
            return ((fused_sdf_kernel(emb, ws, bs),), (fused_sdf_kernel_variant(emb, ws, bs, "scalar"),),
                    (fused_sdf_plain(emb, ws, bs),),
                    (fused_sdf_plain(emb.double(), [w.double() for w in ws], [b.double() for b in bs]),))
        x, d, _ = _field_inputs(n_points, seed=n_points)
        flat = tuple(w.detach().contiguous() for w in _flatten_eff(model))
        return (F.field_fwd_kernel(flat, x, d, icfg, cd), F.field_fwd_kernel_variant(flat, x, d, icfg, cd, "scalar"),
                F.field_math(flat, x, d, icfg, rcfg, cd),
                F.field_math(tuple(t.double() for t in flat), x.double(), d.double(), icfg, rcfg, torch.float64))


@pytest.mark.parametrize("sizes", [(1, 127, 128, 129, 1000), (100_352,)], ids=["ragged", "field_pass"])
@pytest.mark.parametrize("kernel", ["k1", "k3"])
def test_f32_tf32_kernels_match_plain_and_f64(setup, kernel, sizes, capsys):
    """The f32 K1 and K3-fwd of finalize and render eval (3xTF32) against
    the plain version (1e-3 of each output's scale) at each size, and
    against the plain version in f64 beside the scalar variant: each
    output's max |err| at most 1.5x plain f32's and 1.5x the scalar
    variant's, or 2^-20 of the largest f64 entry, over the sizes' points
    together (a single point's f32 error is a matter of chance at that
    floor's scale)."""
    errs = []  # per size: (kernel, scalar, plain) errors against f64, and the scale, of each output
    for n in sizes:
        got, scalar, plain, ref64 = _f32_routes(setup, kernel, n)
        for a, s_, p in zip(got, scalar, plain):
            assert a.shape == p.shape and bool(torch.isfinite(a).all())
            assert _err(a, p) < TOL[torch.float32] and _err(s_, p) < TOL[torch.float32]
        errs.append((_f64_errors(got, ref64), _f64_errors(scalar, ref64), _f64_errors(plain, ref64),
                     [float(r.abs().max()) for r in ref64]))
    worst = [list(map(max, zip(*route))) for route in zip(*errs)]  # the union of the sizes' points
    for k, s_, p, scale in zip(*worst):
        floor = 2.0 ** -20 * scale
        assert k <= max(1.5 * p, floor) and k <= max(1.5 * s_, floor), (k, s_, p, floor)
    with capsys.disabled():
        print(f"\n{kernel} f32 n={sizes}: off f64, 3xTF32 {worst[0]}, scalar {worst[1]}, plain {worst[2]}")


def _k4_inputs(rays, lanes, seed):
    gen = _gen(seed)
    z = torch.sort(torch.rand((rays, lanes), generator=gen, device="cuda") * 6.0, dim=-1).values
    sdf = (z - 3.0).abs() - 1.5 + 0.3 * torch.randn((rays, lanes), generator=gen, device="cuda")
    beta = torch.rand((rays,), generator=gen, device="cuda") * 0.45 + 0.05
    return z, sdf, beta, torch.tensor([2.1e-3], device="cuda")


@pytest.fixture(scope="module")
def k4_first_port(setup):
    """The library of K4's first port: the tree's source with every
    bisection step run, also once the beta0 check has passed."""
    from neat_tpu_torch.tools import fused_round_variants as V

    return V.build(["first_port"])["first_port"]


@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("lanes", [128, 256, 384, 512, 640, 1024])  # the sampler's five widths and the widest
def test_k4_kernel_matches_plain(setup, k4_first_port, lanes, refine):
    """The wrapper's kernel and the first port against the plain version."""
    from neat_tpu_torch.tools import fused_round_variants as V

    rays = 256
    # at 384 samples the inputs the kernel has been held to since it was ported
    z, sdf, beta, beta0 = _k4_inputs(rays, lanes, seed=int(refine) if lanes == 384 else lanes + int(refine))
    args = (0.1, 10, 0.0, refine)
    bp, wp, pp = R.fused_round_plain(z, sdf, beta, beta0[0], *args)
    outs = [R.fused_round_kernel(z, sdf, beta, beta0, *args), V.launch(k4_first_port, z, sdf, beta, beta0, *args)]
    for bk, wk, pk in outs:
        keep = (bk - bp).abs() <= 2e-4 * bp.abs()
        assert int((~keep).sum()) <= 0.005 * rays
        assert torch.allclose(wk[keep], wp[keep], rtol=2e-4, atol=2e-5)
        assert torch.allclose(pk[keep], pp[keep], rtol=2e-4, atol=2e-5, equal_nan=True)
        assert bool((pk[:, -1] == 0).all()) and (refine or bool((pk == 0).all()))


@pytest.mark.parametrize("refine", [True, False])
def test_k4_exit_keeps_the_first_ports_bits(setup, k4_first_port, refine):
    """A ray whose beta0 check passes skips the bisection, whose every step
    would keep beta0: the kernel gives the first port's values, on rays that
    pass and on rays that do not (NaN where it has NaN: with refine, the far
    rays' pdf is 0 / 0, as in the plain version)."""
    from neat_tpu_torch.tools import fused_round_variants as V

    z, sdf, beta, beta0 = _k4_inputs(256, 384, seed=7)
    sdf[:64] = sdf[:64].abs() + 5.0  # far from any surface
    passed = R.passed_check(z, sdf, beta0[0], 0.1)
    assert bool(passed[:64].all()) and not bool(passed.all())
    args = (0.1, 10, 0.0, refine)
    got = R.fused_round_kernel(z, sdf, beta, beta0, *args)
    old = V.launch(k4_first_port, z, sdf, beta, beta0, *args)
    for a, b in zip(got, old):
        assert bool((a == b).logical_or(a.isnan() & b.isnan()).all())


@pytest.mark.parametrize(
    "kwargs,expected",
    [
        (dict(), dict(sdf=5, fwd_stash=1, bwd_stash=1, rowlocal=1, dw=1)),
        # 128 rays x 98 samples: one chunk of K3-bwd
        (dict(field="recompute"), dict(sdf=5, fwd=1, bwd=1, chunk_fwd=1, chunk_rowlocal=1, chunk_dw=1)),
        (dict(fused_rounds="on"), dict(round=5, sdf=5, fwd_stash=1, bwd_stash=1, rowlocal=1, dw=1)),
    ],
)
def test_training_step_launches_its_kernels(setup, kwargs, expected):
    # the bf16 step's K2-fwd and K3-fwd launch the tensor-core forward;
    # the counters stay on the wrappers the model calls
    cfg = bench_config("bfloat16", device="cuda", **kwargs)
    scene = bench_scene(cfg, device="cuda")
    step, state = bench_step(cfg, device="cuda", n_rays=128)
    fns = dict(sdf=fused_sdf_kernel, fwd_stash=K.field_fwd_stash_kernel, bwd_stash=K.field_bwd_stash_kernel,
               rowlocal=K.field_bwd_rowlocal_kernel, dw=DW.field_dw_kernel,
               fwd=F.field_fwd_kernel, bwd=F.field_bwd_kernel, chunk_fwd=F.field_bwd_chunk_fwd,
               chunk_rowlocal=F.field_bwd_chunk_rowlocal, chunk_dw=F.field_bwd_chunk_dw,
               round=R.fused_round_kernel)
    before = {k: f.launches for k, f in fns.items()}
    state, metrics = step(state, scene, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    assert torch.isfinite(metrics["loss"])
    assert {k: f.launches - before[k] for k, f in fns.items()} == {k: expected.get(k, 0) for k in fns}


def test_runner_trains_and_resumes_exactly_on_the_card(setup, tmp_path):
    """The training CLI's runner on a generated 64 x 64 scene, abc-neat-a at
    full width on the card: 2 epochs, every step launching the main path's
    kernels with a finite loss; a resumed runner's state equals the saved
    one bit for bit. The runner seeds each step's own generator."""
    import os.path as osp

    from neat_tpu_torch.data.synthetic import generate_scene
    from neat_tpu_torch.train import runner as RUN
    from neat_tpu_torch.train.checkpoint import host_state, load_checkpoint

    repo = osp.dirname(osp.dirname(osp.abspath(__file__)))
    text = open(osp.join(repo, "confs", "abc-neat-a.conf")).read()
    assert "img_res = [512, 512]" in text
    conf = tmp_path / "abc64.conf"
    conf.write_text(text.replace("img_res = [512, 512]", "img_res = [64, 64]"))
    generate_scene(str(tmp_path / "data" / "abc" / "00075213"), n_views=3, res=(64, 64), seed=0)
    kw = dict(conf=str(conf), data_root=str(tmp_path / "data"), exps_folder=str(tmp_path / "exps"), seed=7)
    fns = dict(sdf=fused_sdf_kernel, fwd_stash=K.field_fwd_stash_kernel, bwd_stash=K.field_bwd_stash_kernel,
               rowlocal=K.field_bwd_rowlocal_kernel, dw=DW.field_dw_kernel, fwd=F.field_fwd_kernel,
               bwd=F.field_bwd_kernel, round=R.fused_round_kernel)
    expected = dict(sdf=5, fwd_stash=1, bwd_stash=1, rowlocal=1, dw=1, fwd=0, bwd=0, round=0)

    runner = RUN.TrainRunner(nepochs=1, **kw)
    per_step = []
    step = runner.step_fn

    def counted(state, scene, gen):
        before = {k: f.launches for k, f in fns.items()}
        state, aux = step(state, scene, gen)
        per_step.append(({k: f.launches - before[k] for k, f in fns.items()}, float(aux["loss"])))
        return state, aux

    runner.step_fn = counted
    try:
        runner.run()
    finally:
        runner.close()
    assert runner.n_views == 3 and len(per_step) == 2 * 3
    for launches, loss in per_step:
        assert launches == expected and math.isfinite(loss)
    saved, epoch = load_checkpoint(runner.ckpt_dir)
    resumed = RUN.TrainRunner(nepochs=2, is_continue=True, **kw)
    resumed.close()
    got = host_state(resumed.state)
    assert resumed.start_epoch == epoch == 1 and got["step"] == saved["step"] == 6
    for part in ("params", "mu", "nu"):
        assert got[part].keys() == saved[part].keys()
        assert all(got[part][k].tobytes() == saved[part][k].tobytes() for k in saved[part])


@pytest.fixture(scope="module")
def eval_scene(tmp_path_factory):
    """A generated 64 x 64, 2-view ABC scene at finalize's distance 1 and
    the full-width model (random weights) in f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from neat_tpu_torch.data.datasets import load_blender_scene
    from neat_tpu_torch.data.synthetic import generate_scene
    from neat_tpu_torch.model.neat import NeatConfig

    root = tmp_path_factory.mktemp("eval")
    generate_scene(str(root / "toy"), n_views=2, res=(64, 64), seed=0)
    scene = load_blender_scene("toy", (64, 64), data_root=str(root), distance_threshold=1.0)
    cfg = NeatConfig.for_abc()
    return cfg, init_neat(cfg, seed=3, device="cuda").requires_grad_(False), scene


def test_view_field_lines_on_the_f32_kernels_matches_plain(eval_scene):
    """One chunk of finalize's field evaluation: 5 launches of the f32 K1
    and 1 of the f32 K3-fwd, nothing else. The kernels' route, the plain
    route in f32 and the plain route in f64 (the reference): on z, lines3d,
    lines2d and l3d, the kernels' rays more than 1e-4 of the output's
    largest entry off the reference are at most the plain f32 route's plus
    0.5% of the rays or 3 (f32 in any summation order moves a few rays:
    the inverse CDF in a near-empty bin, l3d's division on a grazing ray),
    and the median ray is within 1e-4."""
    import copy

    import neat_tpu_torch.wireframe.finalize as FIN

    cfg, model, scene = eval_scene
    n = int(scene.mask[0].sum())
    assert 0 < n <= 2048
    zs = []
    orig = FIN.neat_forward

    def rec(*a, **k):
        out = orig(*a, **k)
        zs.append(out["z_vals"][:n].cpu())
        return out

    FIN.neat_forward = rec
    try:
        before = (fused_sdf_kernel.launches, F.field_fwd_kernel.launches, K.field_fwd_stash_kernel.launches)
        routes = [FIN.view_field_lines(model, cfg, scene, 0, 2048)]
        after = (fused_sdf_kernel.launches, F.field_fwd_kernel.launches, K.field_fwd_stash_kernel.launches)
        routes.append(FIN.view_field_lines(model, cfg, scene, 0, 2048, kernels=False))
        routes.append(FIN.view_field_lines(copy.deepcopy(model).double(), cfg, scene, 0, 2048, kernels=False))
    finally:
        FIN.neat_forward = orig
    assert tuple(a - b for a, b in zip(after, before)) == (cfg.sampler.max_total_iters, 1, 0)
    outs = [[z, *(torch.from_numpy(x) for x in r[:3])] for z, r in zip(zs, routes)]
    for got, plain, ref in zip(*outs):
        assert torch.isfinite(got).all()
        err = lambda a: (a.reshape(n, -1).double() - ref.reshape(n, -1)).abs().amax(dim=1) / ref.abs().max()
        ek, ep = err(got), err(plain)
        assert int((ek > 1e-4).sum()) <= int((ep > 1e-4).sum()) + max(3, 0.005 * n)
        assert float(ek.median()) <= 1e-4


def test_render_chunk_and_mesh_grid_on_the_f32_kernels(eval_scene):
    """render_view's chunks and the mesh grid: the f32 K1 and K3-fwd, each
    chunk 5 + 1 launches, the grid 1 K1 launch a chunk; rgb, normal and
    depth against the plain route: pixels more than 1e-4 of the output's
    largest entry off (a sampler decision flipped on the ray) at most 0.5%
    of the view; the grid's SDF within 1e-3 (f32, the K1 checks' limit)."""
    import numpy as np

    import neat_tpu_torch.evaluation.render_eval as RE

    cfg, model, scene = eval_scene
    before = (fused_sdf_kernel.launches, F.field_fwd_kernel.launches)
    got = RE.render_view(model, cfg, scene, 1, chunksize=1024)
    after = (fused_sdf_kernel.launches, F.field_fwd_kernel.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (4 * cfg.sampler.max_total_iters, 4)
    want = RE.render_view(model, cfg, scene, 1, chunksize=1024, kernels=False)
    for k in want:
        assert np.isfinite(got[k]).all()
        off = np.abs(got[k] - want[k]).reshape(64 * 64, -1).max(axis=1) > 1e-4 * np.abs(want[k]).max()
        assert off.sum() <= 0.005 * off.size, (k, int(off.sum()))
    pts = np.random.RandomState(0).uniform(-1.5, 1.5, (70000, 3)).astype(np.float32)
    before = fused_sdf_kernel.launches
    grid_k = RE.grid_sdf_fn(model, cfg)(pts)
    assert fused_sdf_kernel.launches - before == 1
    assert _err(torch.from_numpy(grid_k), torch.from_numpy(RE.grid_sdf_fn(model, cfg, kernels=False)(pts))) <= 1e-3


@pytest.mark.parametrize("check_every", [1, 4, 64])
def test_dbscan_on_the_card_matches_the_cpu(setup, check_every):
    """DBSCAN of 2048 points (clumps with repeated points, an eps-chain of
    130 links in index order, noise) on the card: the valid rows exactly as
    on the CPU, the means within 1e-6 (the sums in another order)."""
    from neat_tpu_torch.assignment.clustering import dbscan_cluster_means

    gen = torch.Generator().manual_seed(7)
    centres = torch.rand((150, 3), generator=gen) * 3 - 1.5
    clumps = (centres[:, None] + (torch.rand((150, 6, 3), generator=gen) - 0.5) * 0.004).reshape(-1, 3)
    clumps[1::6] = clumps[0::6]  # rays through one pixel repeat exactly
    chain = torch.tensor([2.5, -2.5, -2.5]) + torch.arange(130)[:, None] * torch.tensor([0.009, 0.0, 0.0])
    noise = torch.rand((2048 - 900 - 130, 3), generator=gen) * 6 - 3
    pts = torch.cat([clumps, chain, noise]).float()
    m_ref, v_ref = dbscan_cluster_means(pts)
    m, v = dbscan_cluster_means(pts.cuda(), check_every=check_every)
    assert int(v_ref.sum()) > 100 and torch.equal(v.cpu(), v_ref)
    assert float((m.cpu()[v_ref] - m_ref[v_ref]).abs().max()) <= 1e-6


def test_host_assignment_and_dbscan_return_on_the_card(setup):
    """The callback assignment and dbscan_callback_means take CUDA tensors
    and give back CUDA tensors equal to their CPU runs."""
    from neat_tpu_torch.assignment.clustering import dbscan_callback_means
    from neat_tpu_torch.assignment.matching import masked_assignment

    gen = torch.Generator().manual_seed(8)
    cost = torch.rand((512, 300), generator=gen)
    rows, cols = torch.rand(512, generator=gen) < 0.05, torch.rand(300, generator=gen) < 0.7
    ref = masked_assignment(cost, rows, cols, method="callback")
    got = masked_assignment(cost.cuda(), rows.cuda(), cols.cuda(), method="callback")
    assert all(g.is_cuda and torch.equal(g.cpu(), r) for g, r in zip(got, ref))
    pts = (torch.rand((64, 3), generator=gen) * 0.05).repeat(2, 1)
    mask = torch.rand(128, generator=gen) < 0.9
    ref = dbscan_callback_means(pts, mask, min_samples=3)
    got = dbscan_callback_means(pts.cuda(), mask.cuda(), min_samples=3)
    assert bool(ref[1].any()) and all(g.is_cuda and torch.equal(g.cpu(), r) for g, r in zip(got, ref))
