"""The split field backward (K2-bwd as a row-local pass and a weight-gradient
GEMM) through its plain versions, on the CPU.

* ``field_bwd_split_plain`` against ``field_bwd_stashed`` on the same
  inputs: dx, dd and every bias gradient bit for bit (the row-local pass is
  the same code); every dW within 1e-5 of its largest entry (f32 sums of the
  same exact products in another order: an implicit layer's primal and
  tangent terms in one sum). Canonical widths, f32 and bf16, sizes ragged
  against the 32-point tile and the 64-point chunk, the clamp active.
* against the JAX package's ``field_bwd_stashed`` on the same seed-made
  inputs at narrow widths: f32 within 1e-4 of each output's largest entry
  (``test_torch_ops.py``'s backward tolerance), f64 within 1e-10; bf16
  within 2e-2 (``test_torch_fused_field.py``'s bf16 tolerance: the cotangent
  rounded to bf16 after an f32 sum in another order can land one bf16 step
  away); and at an exact sdf_raw == sphere tie in f64.
* the workspace: pack and unpack round trip, padded points zero; the row
  table the producer takes at launch names every operand's first row.
* the GEMM's schedule (``dw_schedule_plain``: its units and tiles run in
  plain PyTorch) covers each product once: it equals ``field_dw_plain``
  within 1e-6 at 1, 127, 129 and 1000 points.
* the variant API refuses what the kernels do not take: unknown variants,
  f32 for either variant, CPU tensors; nothing is counted.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neat_tpu.ops.fused_field_stash as jfs
import neat_tpu_torch.model.neat as tneat
from _torch_helpers import configs, n, port_model, to_numpy
from neat_tpu_torch.ops import field_dw as DW
from neat_tpu_torch.ops import fused_field as F
from neat_tpu_torch.ops import fused_field_stash as K

import neat_tpu.model.neat as jneat


def _flat(cd, seed=0):
    """38 operands of the canonical shapes: W (in, out) in cd, b (1, out) f32."""
    rs = np.random.RandomState(seed)
    flat = []
    for i, o in F.CANONICAL_SHAPES:
        flat += [
            torch.as_tensor(rs.randn(i, o).astype(np.float32) * (1.5 / np.sqrt(i))).to(cd),
            torch.as_tensor(rs.randn(1, o).astype(np.float32) * 0.1),
        ]
    return tuple(flat)


def _inputs(n_pts, seed=3, np_dt=np.float32):
    """Points with a quarter past the bounding sphere (clamp active), unit
    directions, cotangents."""
    rs = np.random.RandomState(seed)
    x = rs.rand(n_pts, 3) * 2.4 - 1.2
    far = max(1, n_pts // 4)
    x[:far] *= 3.2 / np.linalg.norm(x[:far], axis=-1, keepdims=True)
    d = rs.randn(n_pts, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cots = [rs.randn(n_pts, w) for w in (1, 3, 3, 6)]
    return x.astype(np_dt), d.astype(np_dt), [c.astype(np_dt) for c in cots]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _canonical(cd, n_pts, seed=0):
    icfg, rcfg = tneat.NeatConfig.for_abc().implicit, tneat.NeatConfig.for_abc().rendering
    flat = _flat(cd, seed)
    x, d, cots = _inputs(n_pts, seed + 1)
    x, d, cots = torch.as_tensor(x), torch.as_tensor(d), [torch.as_tensor(c) for c in cots]
    _, res = K.field_fwd_res(flat, x, d, icfg, rcfg, cd)
    return flat, x, d, res, cots, icfg, rcfg


@pytest.mark.parametrize("n_pts", [3, 33, 129])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_split_equals_stashed(cd, n_pts):
    args = _canonical(cd, n_pts)
    assert bool((args[1].norm(dim=-1) > 3.0).any())  # the clamp is active somewhere
    deff_s, dx_s, dd_s = K.field_bwd_stashed(*args, cd)
    deff, dx, dd = K.field_bwd_split_plain(*args, cd)
    assert torch.equal(dx, dx_s) and torch.equal(dd, dd_s)
    assert len(deff) == 38
    for l in range(19):
        assert torch.equal(deff[2 * l + 1], deff_s[2 * l + 1]), f"db_{l}"
        a, b = deff[2 * l], deff_s[2 * l]
        assert a.shape == b.shape and a.dtype == torch.float32
        assert _rel(n(a), n(b)) <= 1e-5, (l, _rel(n(a), n(b)))


def _to_jax(a):
    """A torch tensor as a JAX array of the same dtype (bf16 through f32)."""
    if not isinstance(a, torch.Tensor):
        return jnp.asarray(a)
    if a.dtype == torch.bfloat16:
        return jnp.asarray(n(a.float()), dtype=jnp.bfloat16)
    return jnp.asarray(n(a))


def _narrow(dtype, seed=4, n_pts=48):
    np_dt = {"float32": np.float32, "float64": np.float64, "bfloat16": np.float32}[dtype]
    cfg_j, cfg_t = configs()
    params = jneat.init_neat(jax.random.PRNGKey(seed), cfg_j)
    sub = {k: params[k] for k in ("implicit", "rendering", "attraction")}
    model = port_model(params, cfg_t, torch.float64 if dtype == "float64" else torch.float32)
    x, d, cots = _inputs(n_pts, seed, np_dt)
    return cfg_j, cfg_t, sub, model, x, d, cots


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("float64", 1e-10), ("bfloat16", 2e-2)])
def test_split_matches_jax(dtype, tol):
    cfg_j, cfg_t, sub, model, x, d, cots = _narrow(dtype)
    th_dt = getattr(torch, dtype)
    jx_dt = {"float32": jnp.float32, "float64": jnp.float64, "bfloat16": jnp.bfloat16}[dtype]
    flat = tuple(w.detach() for w in F._flatten_eff(model))
    t = lambda a: torch.as_tensor(np.asarray(a))
    with torch.no_grad():
        _, res = K.field_fwd_res(flat, t(x), t(d), cfg_t.implicit, cfg_t.rendering, th_dt)
        deff, dx, dd = K.field_bwd_split_plain(
            flat, t(x), t(d), res, [t(c) for c in cots], cfg_t.implicit, cfg_t.rendering, th_dt
        )
    with jax.enable_x64(dtype == "float64"):
        j = _to_jax
        jres = (j(res[0]), tuple(map(j, res[1])), tuple(map(j, res[2])), tuple(map(j, res[3])),
                j(res[4]), j(res[5]), j(res[6]))
        deff_j, dx_j, dd_j = jfs.field_bwd_stashed(
            tuple(map(j, flat)), j(x), j(d), jres, tuple(map(jnp.asarray, cots)),
            cfg_j.implicit, cfg_j.rendering, jx_dt,
        )
        deff_j, dx_j, dd_j = to_numpy(deff_j), np.asarray(dx_j, np.float64), np.asarray(dd_j, np.float64)
    assert bool((np.linalg.norm(x, axis=-1) > 3.0).any())
    assert _rel(n(dx), dx_j) < tol and _rel(n(dd), dd_j) < tol, (_rel(n(dx), dx_j), _rel(n(dd), dd_j))
    assert len(deff) == len(deff_j) == 38
    for i, (a, b) in enumerate(zip(deff, deff_j)):
        assert _rel(n(a), np.asarray(b, np.float64)) < tol, (i, _rel(n(a), np.asarray(b, np.float64)))


def test_split_at_a_clamp_tie_matches_jax():
    """At an exact sdf_raw == sphere tie (f64, one point) the split backward
    equals the stashed one (dx bit for bit) and agrees with the JAX
    package's, whose min sends half of the cotangent into each branch."""
    cfg_j, cfg_t, _, model, _, _, _ = _narrow("float64", seed=11, n_pts=4)
    icfg, rcfg = cfg_t.implicit, cfg_t.rendering
    x = torch.tensor([[0.5, 0.25, -0.125]], dtype=torch.float64)  # exact norm ops
    d = torch.tensor([[0.0, 0.0, 1.0]], dtype=torch.float64)
    flat = [w.detach().to(torch.float64) for w in F._flatten_eff(model)]
    nosphere = dataclasses.replace(icfg, sdf_bounding_sphere=0.0)
    sphere_val = float(icfg.sphere_scale * (icfg.sdf_bounding_sphere - torch.linalg.norm(x[0])))
    last_b = 2 * (F.N_IMPLICIT_LAYERS - 1) + 1
    raw = lambda fe: float(K.field_fwd_res(fe, x, d, nosphere, rcfg, torch.float64)[0][0][0, 0])
    for _ in range(8):  # sdf_raw is affine in the last bias: a few corrections pin the tie
        gap = sphere_val - raw(flat)
        if gap == 0.0:
            break
        flat[last_b] = flat[last_b].clone()
        flat[last_b][0, 0] += gap
    assert raw(flat) == sphere_val, "could not pin an exact tie"
    (sdf, _, _, _), res = K.field_fwd_res(flat, x, d, icfg, rcfg, torch.float64)
    assert float(sdf[0, 0]) == sphere_val
    cots = [torch.tensor(np.random.RandomState(3).randn(1, w)) for w in (1, 3, 3, 6)]
    deff, dx, dd = K.field_bwd_split_plain(flat, x, d, res, cots, icfg, rcfg, torch.float64)
    _, dx_s, dd_s = K.field_bwd_stashed(flat, x, d, res, cots, icfg, rcfg, torch.float64)
    assert torch.equal(dx, dx_s) and torch.equal(dd, dd_s)
    with jax.enable_x64(True):
        j = lambda a: jnp.asarray(n(a))
        jres = (j(res[0]), tuple(map(j, res[1])), tuple(map(j, res[2])), tuple(map(j, res[3])),
                j(res[4]), j(res[5]), j(res[6]))
        deff_j, dx_j, _ = jfs.field_bwd_stashed(
            tuple(map(j, flat)), j(x), j(d), jres, tuple(map(j, cots)),
            cfg_j.implicit, cfg_j.rendering, jnp.float64,
        )
        dx_j, deff_j = np.asarray(dx_j), to_numpy(deff_j)
    np.testing.assert_allclose(n(dx), dx_j, rtol=1e-10, atol=1e-10)
    for a, b in zip(deff, deff_j):
        np.testing.assert_allclose(n(a), b, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("n_pts", [1, 64, 100])
def test_workspace_round_trips(n_pts):
    flat, x, d, res, cots, icfg, rcfg = _canonical(torch.bfloat16, n_pts, seed=5)
    ws, _, _, _, _ = K.field_bwd_rowlocal_plain(flat, x, d, res, cots, icfg, rcfg, torch.bfloat16)
    assert ws.shape == (DW.WS_ROWS, DW.ws_points(n_pts)) and ws.dtype == torch.bfloat16
    assert ws.shape[1] % DW.WS_CHUNK == 0 and ws.shape[1] >= n_pts
    assert not ws[:, n_pts:].any()  # padded points: zeros in every operand
    ops = DW.unpack_workspace(ws, n_pts)
    assert torch.equal(DW.pack_workspace(ops, n_pts, torch.bfloat16), ws)
    # the operands are the ones field_bwd_stashed multiplies, rounded to bf16
    prods, _, _, _ = K._bwd_rowlocal(flat, x, d, res, cots, icfg, rcfg, torch.bfloat16)
    for l, pairs in enumerate(prods):
        for (a, y), (ka, ky) in zip(pairs, (("in", "cot"), ("tin", "tcot"))):
            if (ka, l) in ops:
                assert torch.equal(ops[ka, l], a.to(torch.bfloat16)), (ka, l)
                assert torch.equal(ops[ky, l], y.to(torch.bfloat16)), (ky, l)
    assert DW.WS_ROWS == 12852
    with pytest.raises(ValueError):
        DW.pack_workspace({**ops, ("cot", 3): ops["cot", 2]}, n_pts, torch.bfloat16)


def test_row_table_names_every_operand_once():
    """``ws_row_table``, the producer's ``WsOut`` rows: every layer's input,
    the tangent inputs of layers 0..7, every cotangent, the tangent
    cotangents, each group in layer order; the operands it starts tile the
    workspace's rows without overlap."""
    table = DW.ws_row_table()
    groups = [("in", 19), ("tin", 8), ("cot", 19), ("tcot", 8)]
    assert len(table) == sum(c for _, c in groups) == 54
    at = 0
    for kind, count in groups:
        assert table[at : at + count] == [DW.WS_ROW[kind, l] for l in range(count)], kind
        at += count
    spans = sorted((DW.WS_ROW[key], DW.WS_ROW[key] + r) for key, r in DW.ws_operands())
    assert spans[0][0] == 0 and spans[-1][1] == DW.WS_ROWS
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert sorted(table) == [s for s, _ in spans]


@pytest.mark.parametrize("n_pts", [1, 127, 129, 1000])
def test_gemm_schedule_covers_each_product_once(n_pts):
    rs = np.random.RandomState(n_pts)
    width = DW.ws_points(n_pts)
    ws = torch.as_tensor(rs.randn(DW.WS_ROWS, width).astype(np.float32)).to(torch.bfloat16)
    ws[:, n_pts:] = 0
    got = DW.dw_schedule_plain(ws, n_pts, n_sm=3)
    want = DW.field_dw_plain(ws)
    offs = DW.param_offsets()
    for l, (i, o) in enumerate(F.CANONICAL_SHAPES):
        a = got[offs[l] : offs[l] + i * o].view(i, o)
        assert _rel(n(a), n(want[l])) <= 1e-6, l
        assert not got[offs[l] + i * o : offs[l] + i * o + o].any()  # biases untouched
    units, tiles = DW.dw_schedule(n_pts, 3)
    assert units.dtype == tiles.dtype == torch.int32
    assert units.shape[1] == DW.UNIT_INTS and tiles.shape[1] == DW.TILE_INTS


def _calls():
    flat = _flat(torch.bfloat16)
    icfg = tneat.NeatConfig.for_abc().implicit
    bf, f32 = torch.bfloat16, torch.float32
    n_ = 4
    x, d = torch.zeros((n_, 3)), torch.zeros((n_, 3))
    scd, sf32 = torch.zeros((n_, K.W_CD), dtype=bf), torch.zeros((n_, K.W_F32))
    rgb, grads = torch.zeros((n_, 3)), torch.zeros((n_, 3))
    cots = [torch.zeros((n_, w)) for w in (1, 3, 3, 6)]
    args = (flat, x, d, scd, sf32, rgb, grads, cots, icfg)
    ws = torch.zeros((DW.WS_ROWS, DW.ws_points(n_)), dtype=bf)
    return {
        "bwd_cpu": (ValueError, lambda: K.field_bwd_stash_kernel(*args, bf)),
        "split_cpu": (ValueError, lambda: K.field_bwd_stash_kernel_variant(*args, bf, "split")),
        "scalar_cpu": (ValueError, lambda: K.field_bwd_stash_kernel_variant(*args, bf, "scalar")),
        "mma_cpu": (ValueError, lambda: K.field_bwd_rowlocal_kernel(*args, variant="mma")),
        "rowlocal_cpu": (ValueError, lambda: K.field_bwd_rowlocal_kernel(*args)),
        "split_f32": (TypeError, lambda: K.field_bwd_stash_kernel_variant(*args, f32, "split")),
        "scalar_f32": (TypeError, lambda: K.field_bwd_stash_kernel_variant(*args, f32, "scalar")),
        "unknown": (ValueError, lambda: K.field_bwd_stash_kernel_variant(*args, bf, "wgmma")),
        "gemm_cpu": (ValueError, lambda: DW.field_dw_kernel(ws, n_, torch.zeros(F._n_param_grads()))),
    }


@pytest.mark.parametrize("case", list(_calls()))
def test_bwd_variants_refuse_what_the_kernels_do_not_take(case):
    err, call = _calls()[case]
    counters = (K.field_bwd_stash_kernel, K.field_bwd_rowlocal_kernel, DW.field_dw_kernel)
    before = [f.launches for f in counters]
    with pytest.raises(err):
        call()
    assert [f.launches for f in counters] == before
