"""neat_tpu_torch.fields against neat_tpu.fields at narrow widths (64 x 8
SDF with the skip at 4, 4 x 64 heads), on the same weights.

Outputs are compared in f32 at rtol 1e-5; parameter gradients of a scalar
that uses the spatial gradient (so grad-of-grad is exercised) at 2e-5 of
each gradient's largest entry — the two autodiff systems sum the same
products in different orders through a second-order chain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neat_tpu.fields.mlp as jmlp
import neat_tpu.model.neat as jneat
import neat_tpu_torch.fields.mlp as tmlp
from _torch_helpers import configs, n, port_model, t, to_numpy
from neat_tpu_torch.interop import params_from_jax


def _inputs(rs, n_pts=40):
    x = (rs.randn(n_pts, 3) * 1.2).astype(np.float32)
    x[:6] *= 3.2 / np.linalg.norm(x[:6], axis=-1, keepdims=True)  # clamp active
    d = rs.randn(n_pts, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cots = [rs.randn(n_pts, w).astype(np.float32) for w in (1, 3, 3, 6)]
    return x, d, cots


def _jax_fields(params, cfg, x, d, cots, compute_dtype=None):
    sdf, feats, grads = jmlp.implicit_sdf_feat_grad(params["implicit"], x, cfg.implicit, compute_dtype=compute_dtype)
    rgb = jmlp.render_forward(params["rendering"], x, grads, d, feats, cfg.rendering, compute_dtype=compute_dtype)
    lines = jmlp.attraction_forward(params["attraction"], x, grads, d, feats, cfg.attraction, compute_dtype=compute_dtype)
    eik = jmlp.implicit_gradient(params["implicit"], x, cfg.implicit)
    scalar = (
        jnp.sum(sdf * cots[0]) + jnp.sum(grads * cots[1]) + jnp.sum(rgb * cots[2])
        + jnp.sum(lines.reshape(-1, 6) * cots[3]) + jnp.sum((jnp.linalg.norm(eik, axis=-1) - 1) ** 2)
    )
    return (sdf, feats, grads, rgb, lines, eik), scalar


def _torch_fields(model, cfg, x, d, cots, compute_dtype=None):
    sdf, feats, grads = tmlp.implicit_sdf_feat_grad(model.implicit, x, cfg.implicit, compute_dtype=compute_dtype)
    rgb = tmlp.render_forward(model.rendering, x, grads, d, feats, cfg.rendering, compute_dtype=compute_dtype)
    lines = tmlp.attraction_forward(model.attraction, x, grads, d, feats, cfg.attraction, compute_dtype=compute_dtype)
    eik = tmlp.implicit_gradient(model.implicit, x, cfg.implicit)
    scalar = (
        torch.sum(sdf * cots[0]) + torch.sum(grads * cots[1]) + torch.sum(rgb * cots[2])
        + torch.sum(lines.reshape(-1, 6) * cots[3]) + torch.sum((torch.linalg.norm(eik, dim=-1) - 1) ** 2)
    )
    return (sdf, feats, grads, rgb, lines, eik), scalar


def test_field_outputs_and_param_grads_match():
    cfg_j, cfg_t = configs()
    params = jneat.init_neat(jax.random.PRNGKey(2), cfg_j)
    model = port_model(params, cfg_t)
    rs = np.random.RandomState(0)
    x, d, cots = _inputs(rs)

    keys = ("implicit", "rendering", "attraction")
    sub = {k: params[k] for k in keys}

    def jloss(p):
        return _jax_fields(p, cfg_j, jnp.asarray(x), jnp.asarray(d), [jnp.asarray(c) for c in cots])[1]

    outs_j, _ = _jax_fields(sub, cfg_j, jnp.asarray(x), jnp.asarray(d), [jnp.asarray(c) for c in cots])
    g_j = params_from_jax(to_numpy(jax.jit(jax.grad(jloss))(sub)))

    outs_t, scalar_t = _torch_fields(model, cfg_t, t(x), t(d), [t(c) for c in cots])
    names = [k for k, _ in model.named_parameters() if k.split(".")[0] in keys]
    plist = [dict(model.named_parameters())[k] for k in names]
    g_t = dict(zip(names, torch.autograd.grad(scalar_t, plist)))

    for a, b, name in zip(outs_t, outs_j, ("sdf", "feats", "grads", "rgb", "lines", "eik")):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-5, atol=2e-6, err_msg=name)
    assert set(g_t) == set(g_j)
    for k in names:
        ref = g_j[k].numpy()
        err = np.abs(n(g_t[k]) - ref).max() / (np.abs(ref).max() + 1e-12)
        assert err < 2e-5, (k, err)


def test_global_junctions_and_bf16_chain_match():
    """The junction decoder in f32, and the bf16 compute-dtype SDF chain
    (rounded at the same places; 1e-2 relative covers bf16's 8-bit
    mantissa through eight layers)."""
    cfg_j, cfg_t = configs()
    params = jneat.init_neat(jax.random.PRNGKey(3), cfg_j)
    model = port_model(params, cfg_t)
    np.testing.assert_allclose(
        n(tmlp.global_junctions_forward(model.junctions, cfg_t.junctions)),
        np.asarray(jmlp.global_junctions_forward(params["junctions"], cfg_j.junctions)),
        rtol=1e-5, atol=1e-6,
    )
    x = np.random.RandomState(1).randn(64, 3).astype(np.float32)
    a = tmlp.implicit_sdf(model.implicit, t(x), cfg_t.implicit, compute_dtype=torch.bfloat16)
    b = jmlp.implicit_sdf(params["implicit"], jnp.asarray(x), cfg_j.implicit, compute_dtype=jnp.bfloat16)
    np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("geometric", [True, False])
def test_init_shapes_and_names_match_jax(geometric):
    """The port's own init builds the same parameter names and shapes as
    the JAX init (its draws differ: torch.Generator vs jax.random)."""
    cfg_j, cfg_t = configs()
    icfg_j = jmlp.ImplicitNetConfig(dims=(64,) * 8, geometric_init=geometric)
    icfg_t = tmlp.ImplicitNetConfig(dims=(64,) * 8, geometric_init=geometric)
    ref = params_from_jax(to_numpy(jmlp.init_implicit_net(jax.random.PRNGKey(0), icfg_j)))
    got = tmlp.init_implicit_net(torch.Generator().manual_seed(0), icfg_t).state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape) for k, v in ref.items()}
    if geometric:
        # the deterministic parts of the sphere init: zeroed encoding
        # columns at layer 0 and at the skip layer, bias -0.6 at the end
        assert float(got["lin0.v"][:, 3:].abs().max()) == 0.0
        assert float(got["lin4.v"][:, -36:].abs().max()) == 0.0
        np.testing.assert_array_equal(n(got["lin8.b"]), ref["lin8.b"].numpy())
