"""The recompute field path (K3) of the port through its plain version,
against neat_tpu.

* ``field_math`` against ``neat_tpu.ops.fused_field._field_math`` on the
  same weights and points, narrow widths: f32 to 1e-5 of each output's
  largest entry (summation order only); bf16 to 2e-2 (both round each
  activation to bf16 at the same places, the f32 sums differ in order, and
  a rare activation lands on the neighbouring bf16 value: one bf16 step is
  2^-8 relative).
* ``fused_field_eval`` (the autograd op) against the JAX op with
  ``interpret=True``: forward, and the gradients with respect to every
  parameter (through the weight norm), the points and the directions, in
  f32 on one 200-point batch (one 256-row tile) with clamp-active points.
  Gradients to 1e-4 of each leaf's largest entry: they hold second-order
  terms through the inner spatial gradient.
* an exact sdf_raw == sphere tie: autograd's ``minimum`` splits the
  gradient evenly, in both packages.
* the no-grad dispatch: ``fused_field_eval_stash`` without a gradient to
  record builds no autograd node, keeps no stash and equals the
  differentiated call.
* the wrappers raise on a CPU tensor instead of falling back.
* no module of the port, nor chip_smoke.py, imports jax or neat_tpu.
"""

import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neat_tpu.model.neat as jneat
import neat_tpu.ops.fused_field as jff
import neat_tpu_torch.ops.fused_field as tff
import neat_tpu_torch.ops.fused_field_stash as tfs
from _torch_helpers import configs, n, port_model, t, to_numpy
from neat_tpu_torch.interop import params_from_jax

NETS = ("implicit", "rendering", "attraction")


def _setup(seed=4, n_pts=200):
    """Narrow nets on the same weights and points with a quarter past the
    bounding sphere (clamp active)."""
    cfg_j, cfg_t = configs()
    params = jneat.init_neat(jax.random.PRNGKey(seed), cfg_j)
    sub = {k: params[k] for k in NETS}
    model = port_model(params, cfg_t)
    rs = np.random.RandomState(seed)
    x = rs.rand(n_pts, 3) * 2.4 - 1.2
    x[: n_pts // 4] *= 3.2 / np.linalg.norm(x[: n_pts // 4], axis=-1, keepdims=True)
    d = rs.randn(n_pts, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cots = [rs.randn(n_pts, w).astype(np.float32) for w in (1, 3, 3, 6)]
    return cfg_j, cfg_t, sub, model, x.astype(np.float32), d.astype(np.float32), cots


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_field_math_matches_jax(dtype, tol):
    cfg_j, cfg_t, sub, model, x, d, _ = _setup()
    jx_dt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    ref = jff._field_math(
        jff._flatten_eff(sub), jnp.asarray(x), jnp.asarray(d), cfg_j.implicit, cfg_j.rendering, jx_dt
    )
    with torch.no_grad():
        got = tff.field_math(
            tff._flatten_eff(model), t(x), t(d), cfg_t.implicit, cfg_t.rendering, getattr(torch, dtype)
        )
    assert bool((np.linalg.norm(x, axis=-1) > 3.0).any())  # the clamp is active somewhere
    for a, b, name in zip(got, ref, ("sdf", "grads", "rgb", "att")):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, name
        assert _rel(n(a), np.asarray(b, np.float32)) < tol, (name, _rel(n(a), np.asarray(b, np.float32)))


def test_fused_field_eval_matches_jax_interpret():
    cfg_j, cfg_t, sub, model, x, d, cots = _setup()

    def scalar_j(sub, x, d):
        sdf, grads, rgb, lines = jff.fused_field_eval(
            sub, x, d, cfg_j.implicit, cfg_j.rendering, compute_dtype="float32", interpret=True
        )
        att = (lines - x[:, None, :]).reshape(-1, 6)
        return sum(jnp.sum(o * c) for o, c in zip((sdf, grads, rgb, att), cots)), (sdf, grads, rgb, lines)

    (_, out_j), (g_sub, g_x, g_d) = jax.value_and_grad(scalar_j, argnums=(0, 1, 2), has_aux=True)(
        sub, jnp.asarray(x), jnp.asarray(d)
    )

    xt, dt = t(x).requires_grad_(True), t(d).requires_grad_(True)
    out_t = tff.fused_field_eval(
        model, xt, dt, cfg_t.implicit, cfg_t.rendering, compute_dtype="float32", acfg=cfg_t.attraction
    )
    for a, b, name in zip(out_t, out_j, ("sdf", "grads", "rgb", "lines3d")):
        assert _rel(n(a), b) < 1e-5, (name, _rel(n(a), b))
    att = (out_t[3] - xt[:, None, :]).reshape(-1, 6)
    scalar = sum(torch.sum(o * t(c)) for o, c in zip((*out_t[:3], att), cots))
    named = [(k, p) for k, p in model.named_parameters() if k.split(".")[0] in NETS]
    got = torch.autograd.grad(scalar, [p for _, p in named] + [xt, dt])
    ref = params_from_jax(to_numpy(g_sub))
    assert set(ref) == {k for k, _ in named}
    for (k, _), g in zip(named, got):
        assert _rel(n(g), ref[k].numpy()) < 1e-4, (k, _rel(n(g), ref[k].numpy()))
    assert _rel(n(got[-2]), g_x) < 1e-4 and _rel(n(got[-1]), g_d) < 1e-4


def test_clamp_tie_splits_the_gradient_evenly():
    """At an exact sdf_raw == sphere tie the spatial gradient is half of each
    branch, and so is the cotangent the backward sends into each (f64, one
    point)."""
    _, cfg_t, _, model, _, _, _ = _setup(seed=11, n_pts=4)
    model = model.to(torch.float64)
    icfg, rcfg = cfg_t.implicit, cfg_t.rendering
    x = torch.tensor([[0.5, 0.25, -0.125]], dtype=torch.float64)  # exact norm ops
    d = torch.tensor([[0.0, 0.0, 1.0]], dtype=torch.float64)
    flat = [w.detach() for w in tff._flatten_eff(model)]
    nosphere = dataclasses.replace(icfg, sdf_bounding_sphere=0.0)
    sphere_val = float(icfg.sphere_scale * (icfg.sdf_bounding_sphere - torch.linalg.norm(x[0])))
    last_b = 2 * (tff.N_IMPLICIT_LAYERS - 1) + 1

    def sdf_raw_of(fe):
        with torch.no_grad():
            return float(tff.field_math(fe, x, d, nosphere, rcfg, torch.float64)[0][0, 0])

    for _ in range(8):  # sdf_raw is affine in the last bias: a few corrections pin the tie
        gap = sphere_val - sdf_raw_of(flat)
        if gap == 0.0:
            break
        flat[last_b] = flat[last_b].clone()
        flat[last_b][0, 0] += gap
    assert sdf_raw_of(flat) == sphere_val, "could not pin an exact tie"

    with torch.no_grad():
        g_mlp = tff.field_math(flat, x, d, nosphere, rcfg, torch.float64)[1]
    g_sphere = -icfg.sphere_scale * x / torch.linalg.norm(x[0])
    leaves = [w.clone().requires_grad_(True) for w in (*flat, x, d)]
    out = tff.field_math(leaves[:-2], leaves[-2], leaves[-1], icfg, rcfg, torch.float64)
    assert float(out[0].detach()[0, 0]) == sphere_val
    np.testing.assert_allclose(n(out[1]), n(0.5 * g_mlp + 0.5 * g_sphere), rtol=1e-11, atol=1e-11)

    # the backward at the tie: autograd's minimum sends half of the cotangent
    # into each branch, as jnp.minimum's does, and the whole backward equals
    # the stashed one, whose balanced multipliers are held against JAX's in
    # test_torch_ops.py::test_k2_clamp_tie_balanced_multipliers
    one = jnp.ones(())
    assert [float(g) for g in jax.grad(jnp.minimum, argnums=(0, 1))(one, one)] == [0.5, 0.5]
    cots = [t(np.random.RandomState(3).randn(1, w)) for w in (1, 3, 3, 6)]
    got = torch.autograd.grad(out, leaves, cots)
    with torch.no_grad():
        _, res = tfs.field_fwd_res(flat, x, d, icfg, rcfg, torch.float64)
        deff, dx, dd = tfs.field_bwd_stashed(flat, x, d, res, cots, icfg, rcfg, torch.float64)
    for a, b in zip(got, (*deff, dx, dd)):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-9, atol=1e-10)


def test_stash_eval_without_grad_takes_the_residual_free_forward(monkeypatch):
    """The port's TestStashPrimalDispatch: under no_grad, or when no operand
    requires a gradient, fused_field_eval_stash runs field_primal (K3-fwd on
    the card, field_math here), never the stashing forward."""
    _, cfg_t, _, model, x, d, _ = _setup(seed=7, n_pts=130)
    kw = dict(compute_dtype="float32", acfg=cfg_t.attraction)
    run = lambda: tfs.fused_field_eval_stash(model, t(x), t(d), cfg_t.implicit, cfg_t.rendering, **kw)
    diff = run()  # the parameters require a gradient: the stashing autograd op
    assert all(o.grad_fn is not None for o in diff)

    def no_stash(*a, **k):
        raise AssertionError("the stashing forward ran with nothing to differentiate")

    monkeypatch.setattr(tfs, "field_fwd_res", no_stash)
    monkeypatch.setattr(tfs, "field_fwd_stash_kernel", no_stash)
    with torch.no_grad():
        primal = run()
    for p in model.parameters():
        p.requires_grad_(False)
    frozen = run()  # grad mode on, but no operand requires a gradient
    for a, b, c in zip(primal, diff, frozen):
        assert a.grad_fn is None and not a.requires_grad and c.grad_fn is None
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(n(a), n(b), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(n(a), n(c))


def test_recompute_kernels_refuse_cpu_tensors():
    _, cfg_t, _, model, x, d, cots = _setup(n_pts=8)
    flat = tuple(w.detach() for w in tff._flatten_eff(model))
    with pytest.raises(ValueError):
        tff.field_fwd_kernel(flat, t(x), t(d), cfg_t.implicit, torch.float32)
    with pytest.raises(ValueError):
        tff.field_bwd_kernel(flat, t(x), t(d), [t(c) for c in cots], cfg_t.implicit, torch.float32)
    assert tff.field_fwd_kernel.launches == 0 and tff.field_bwd_kernel.launches == 0


def test_port_imports_neither_jax_nor_neat_tpu():
    root = pathlib.Path(__file__).resolve().parents[1]
    files = [*sorted((root / "neat_tpu_torch").rglob("*.py")), root / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in ("jax", "jaxlib", "neat_tpu", "flax", "optax"), (path, mod)
