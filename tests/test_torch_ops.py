"""The port's kernel modules through their plain versions, against neat_tpu.

* K1: ``fused_sdf_plain`` (via ``fused_sdf_eval`` on CPU tensors) against
  the Pallas kernel in interpret mode, canonical widths, one 1024-point
  tile, bf16. Both round the activations to bf16 at the same places; their
  f32 sums differ in order, so a rare activation rounds to the neighbouring
  bf16 value: 5e-3 absolute on unit-scale sdf values (measured 1.9e-3; a
  bf16 constant rounded the torch way instead, 1.1e-2, fails it).
* K2: ``field_fwd_res`` / ``field_bwd_stashed`` against the JAX functions
  at narrow widths, in f32 (summation order only: 2e-5 of each output's
  largest entry, 1e-4 for the second-order parameter gradients) and f64
  (1e-10), with clamp-active points and an exact clamp tie.
* ``fused_field_eval_stash`` (the autograd op) against ``torch.autograd``
  of the plain forward: the hand-written backward is the exact adjoint in
  f64.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neat_tpu.fields.mlp as jmlp
import neat_tpu.model.neat as jneat
import neat_tpu.ops.fused_field as jff
import neat_tpu.ops.fused_field_stash as jfs
import neat_tpu.ops.fused_sdf as jsdf
import neat_tpu_torch.fields.mlp as tmlp
import neat_tpu_torch.ops.fused_field as tff
import neat_tpu_torch.ops.fused_field_stash as tfs
import neat_tpu_torch.ops.fused_sdf as tsdf
from _torch_helpers import configs, n, port_model, t, to_numpy
from neat_tpu_torch.interop import params_from_jax

DT = {"float32": (np.float32, torch.float32, jnp.float32), "float64": (np.float64, torch.float64, jnp.float64)}


def test_k1_plain_matches_interpret_kernel_bf16():
    cfg_j, cfg_t = jmlp.ImplicitNetConfig(), tmlp.ImplicitNetConfig()
    params = jmlp.init_implicit_net(jax.random.PRNGKey(0), cfg_j)
    net = tmlp.init_implicit_net(torch.Generator().manual_seed(0), cfg_t)
    net.load_state_dict(params_from_jax(to_numpy(params)))
    pts = (np.random.RandomState(0).rand(1024, 3).astype(np.float32) * 2 - 1) * 2.5
    ref = np.asarray(jsdf.fused_sdf_eval(params, jnp.asarray(pts), cfg_j, interpret=True))
    got = n(tsdf.fused_sdf_eval(net, t(pts), cfg_t, "bfloat16"))
    assert got.shape == ref.shape == (1024,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-3)
    # the wrapper's kernel refuses a CPU tensor: no silent fallback
    emb = torch.zeros((4, 39), dtype=torch.bfloat16)
    ws, bs = tsdf._effective_weights(net, cfg_t, torch.bfloat16)
    with pytest.raises(ValueError):
        tsdf.fused_sdf_kernel(emb, ws, bs)


def _field_setup(dtype, seed=4, n_pts=48):
    """Narrow nets on the same weights, flattened for both packages, and
    points with a quarter past the bounding sphere (clamp active)."""
    np_dt, th_dt, jx_dt = DT[dtype]
    cfg_j, cfg_t = configs()
    params = jneat.init_neat(jax.random.PRNGKey(seed), cfg_j)
    sub = {k: params[k] for k in ("implicit", "rendering", "attraction")}
    model = port_model(params, cfg_t, th_dt)
    rs = np.random.RandomState(seed)
    x = rs.rand(n_pts, 3) * 2.4 - 1.2
    x[: n_pts // 4] *= 3.2 / np.linalg.norm(x[: n_pts // 4], axis=-1, keepdims=True)
    d = rs.randn(n_pts, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cots = [rs.randn(n_pts, w) for w in (1, 3, 3, 6)]
    arr = lambda a: a.astype(np_dt)
    return cfg_j, cfg_t, sub, model, arr(x), arr(d), [arr(c) for c in cots]


def _jax_fwd_bwd(sub, cfg_j, x, d, cots, jx_dt):
    sub = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jx_dt), sub)
    flat = jff._flatten_eff(sub)  # weight norm resolved at the working precision
    out, res = jfs.field_fwd_res(flat, jnp.asarray(x), jnp.asarray(d), cfg_j.implicit, cfg_j.rendering, jx_dt)
    deff, dx, dd = jfs.field_bwd_stashed(
        flat, jnp.asarray(x), jnp.asarray(d), res, tuple(jnp.asarray(c) for c in cots),
        cfg_j.implicit, cfg_j.rendering, jx_dt,
    )
    return out, res, (deff, dx, dd)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k2_plain_fwd_bwd_match_jax(dtype):
    np_dt, th_dt, jx_dt = DT[dtype]
    cfg_j, cfg_t, sub, model, x, d, cots = _field_setup(dtype)
    with jax.enable_x64(dtype == "float64"):
        out_j, res_j, (deff_j, dx_j, dd_j) = _jax_fwd_bwd(sub, cfg_j, x, d, cots, jx_dt)
        out_j, res_j = to_numpy(out_j), to_numpy(res_j)
        deff_j, dx_j, dd_j = to_numpy(deff_j), np.asarray(dx_j), np.asarray(dd_j)
    flat = tff._flatten_eff(model)
    with torch.no_grad():
        out_t, res_t = tfs.field_fwd_res(flat, t(x), t(d), cfg_t.implicit, cfg_t.rendering, th_dt)
        deff_t, dx_t, dd_t = tfs.field_bwd_stashed(
            flat, t(x), t(d), res_t, [t(c) for c in cots], cfg_t.implicit, cfg_t.rendering, th_dt
        )
    assert bool((np.linalg.norm(x, axis=-1) > 3.0).any())  # the clamp is active somewhere
    fwd_tol, bwd_tol = (2e-5, 1e-4) if dtype == "float32" else (1e-10, 1e-10)

    def close(a, b, tol, what):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)
        assert err < tol, (what, err)

    for a, b, name in zip(out_t, out_j, ("sdf", "grads", "rgb", "att")):
        close(n(a), b, fwd_tol, name)
    # residuals, packed in the kernels' stash layout
    scd_t, sf32_t = tfs._pack_res(res_t)
    close(n(scd_t), np.concatenate([*res_j[1], *res_j[2], *res_j[3]], axis=-1), fwd_tol, "stash_cd")
    close(n(sf32_t), np.concatenate([res_j[0], res_j[4]], axis=-1), fwd_tol, "stash_f32")
    close(n(dx_t), dx_j, bwd_tol, "dx")
    close(n(dd_t), dd_j, bwd_tol, "dd")
    assert len(deff_t) == len(deff_j) == 38
    for i, (a, b) in enumerate(zip(deff_t, deff_j)):
        close(n(a), b, bwd_tol, f"deff[{i}]")


def test_k2_clamp_tie_balanced_multipliers():
    """At an exact sdf_raw == sphere tie the spatial gradient is 0.5 of each
    branch (the min's balanced multipliers, applied once), and the backward
    agrees with JAX's on the same residuals (mirrors TestStashClampTie)."""
    cfg_j, cfg_t, sub, model, _, _, _ = _field_setup("float64", seed=11, n_pts=4)
    icfg = cfg_t.implicit
    x = torch.tensor([[0.5, 0.25, -0.125]], dtype=torch.float64)  # exact norm ops
    d = torch.tensor([[0.0, 0.0, 1.0]], dtype=torch.float64)
    flat = list(t_.detach() for t_ in tff._flatten_eff(model))
    nosphere = dataclasses.replace(icfg, sdf_bounding_sphere=0.0)
    sphere_val = float(icfg.sphere_scale * (icfg.sdf_bounding_sphere - torch.linalg.norm(x[0])))
    last_b = 2 * (tff.N_IMPLICIT_LAYERS - 1) + 1

    def sdf_raw_of(fe):
        return float(tfs.field_fwd_res(fe, x, d, nosphere, cfg_t.rendering, torch.float64)[0][0][0, 0])

    for _ in range(8):  # sdf_raw is affine in the last bias: a few corrections pin the tie
        gap = sphere_val - sdf_raw_of(flat)
        if gap == 0.0:
            break
        flat[last_b] = flat[last_b].clone()
        flat[last_b][0, 0] += gap
    assert sdf_raw_of(flat) == sphere_val, "could not pin an exact tie"
    (_, g_mlp, _, _), _ = tfs.field_fwd_res(flat, x, d, nosphere, cfg_t.rendering, torch.float64)
    (sdf, grads, _, _), res = tfs.field_fwd_res(flat, x, d, icfg, cfg_t.rendering, torch.float64)
    assert float(sdf[0, 0]) == sphere_val
    g_sphere = -icfg.sphere_scale * x / torch.linalg.norm(x[0])
    np.testing.assert_allclose(n(grads), n(0.5 * g_mlp + 0.5 * g_sphere), rtol=1e-11, atol=1e-11)

    cots = [torch.tensor(np.random.RandomState(3).randn(1, w)) for w in (1, 3, 3, 6)]
    deff_t, dx_t, dd_t = tfs.field_bwd_stashed(flat, x, d, res, cots, icfg, cfg_t.rendering, torch.float64)
    with jax.enable_x64(True):
        jres = jax.tree_util.tree_map(lambda a: jnp.asarray(n(a)), res)
        deff_j, dx_j, dd_j = jfs.field_bwd_stashed(
            tuple(jnp.asarray(n(a)) for a in flat), jnp.asarray(n(x)), jnp.asarray(n(d)), jres,
            tuple(jnp.asarray(n(c)) for c in cots), cfg_j.implicit, cfg_j.rendering, jnp.float64,
        )
        dx_j, deff_j = np.asarray(dx_j), to_numpy(deff_j)
    np.testing.assert_allclose(n(dx_t), dx_j, rtol=1e-10, atol=1e-10)
    for a, b in zip(deff_t, deff_j):
        np.testing.assert_allclose(n(a), b, rtol=1e-10, atol=1e-10)


def test_stash_autograd_op_is_exact_adjoint_f64():
    """The autograd op's backward (field_bwd_stashed over the packed stash)
    against torch.autograd through the plain forward, in f64."""
    _, cfg_t, _, model, x, d, cots = _field_setup("float64", seed=7, n_pts=40)
    icfg, rcfg = cfg_t.implicit, cfg_t.rendering
    xt = t(x).requires_grad_(True)
    dt = t(d).requires_grad_(True)
    params = [p for k, p in model.named_parameters() if k.split(".")[0] in ("implicit", "rendering", "attraction")]
    c = [t(a) for a in cots]

    sdf, grads, rgb, lines = tfs.fused_field_eval_stash(
        model, xt, dt, icfg, rcfg, compute_dtype="float64", acfg=cfg_t.attraction
    )
    att = (lines - xt[:, None, :]).reshape(-1, 6)
    scalar = sum(torch.sum(o * w) for o, w in zip((sdf, grads, rgb, att), c))
    got = torch.autograd.grad(scalar, [*params, xt, dt])

    out, _ = tfs.field_fwd_res(tff._flatten_eff(model), xt, dt, icfg, rcfg, torch.float64)
    ref_scalar = sum(torch.sum(o * w) for o, w in zip(out, c))
    ref = torch.autograd.grad(ref_scalar, [*params, xt, dt])
    for a, b in zip(got, ref):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-9, atol=1e-10)
