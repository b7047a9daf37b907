"""neat_tpu_torch.sampling against neat_tpu.sampling on the same noise.

The error-bounded sampler is run by both packages with the same ``noise``
dict (drawn with numpy) and an f32 SDF callback: an analytic sphere, and
the narrow implicit net on the same weights. With the sphere, z values
agree to 2e-5: the two frameworks take the same f32 steps (bisection,
cumsum, inverse CDF) and differ only where a reduction sums in another
order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neat_tpu.fields.mlp as jmlp
import neat_tpu.model.neat as jneat
import neat_tpu.sampling.samplers as js
import neat_tpu_torch.fields.mlp as tmlp
import neat_tpu_torch.sampling.samplers as ts
from neat_tpu.core.density import LaplaceDensityParams
from neat_tpu_torch.core.density import LaplaceDensity
from _torch_helpers import configs, n, port_model, t

SCFG = dict(n_samples=16, n_samples_eval=32, n_samples_extra=8, max_total_iters=3)


def _rays(rs, n_rays=12):
    d = rs.randn(n_rays, 3).astype(np.float32) * 0.2 + [0.0, 0.0, 1.0]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    cam = np.tile(np.asarray([[0.1, -0.05, -2.0]], np.float32), (n_rays, 1))
    return d, cam


def _noise(rs, n_rays, scfg):
    total = scfg["n_samples_eval"] * scfg["max_total_iters"]
    final = scfg["n_samples"] + scfg["n_samples_extra"] + 2
    return {
        "strat": rs.rand(n_rays, scfg["n_samples_eval"]).astype(np.float32),
        "final_u": rs.rand(n_rays, scfg["n_samples"]).astype(np.float32),
        "z_extra_idx": rs.permutation(total)[: scfg["n_samples_extra"]].astype(np.int32),
        "eik_z_idx": rs.randint(0, final, (n_rays, 1)).astype(np.int32),
    }


def _run_both(sdf_j, sdf_t, rs, training, beta=0.1):
    d, cam = _rays(rs)
    noise = _noise(rs, d.shape[0], SCFG)
    run = jax.jit(
        lambda d, cam, noise: js.error_bound_z_vals(
            jax.random.PRNGKey(0), d, cam, sdf_j,
            LaplaceDensityParams(beta=jnp.asarray(beta)), js.ErrorBoundSamplerConfig(**SCFG),
            training, noise=noise,
        )
    )
    zj, ej = run(jnp.asarray(d), jnp.asarray(cam), {k: jnp.asarray(v) for k, v in noise.items()})
    zt, et = ts.error_bound_z_vals(
        t(d), t(cam), sdf_t, LaplaceDensity(beta), ts.ErrorBoundSamplerConfig(**SCFG),
        training, noise={k: t(v) for k, v in noise.items()},
    )
    return (np.asarray(zj), np.asarray(ej)), (n(zt), None if et is None else n(et))


@pytest.mark.parametrize("training", [True, False])
def test_error_bound_sphere_sdf(training):
    rs = np.random.RandomState(0)
    (zj, ej), (zt, et) = _run_both(
        lambda p: jnp.linalg.norm(p, axis=-1) - 0.8,
        lambda p: torch.linalg.norm(p, dim=-1) - 0.8,
        rs, training,
    )
    assert zt.shape == zj.shape == (12, 16 + 8 + 2)
    np.testing.assert_allclose(zt, zj, rtol=2e-5, atol=2e-5)
    if training:
        np.testing.assert_allclose(et, ej, rtol=2e-5, atol=2e-5)


def test_error_bound_implicit_net_sdf():
    cfg_j, cfg_t = configs()
    params = jneat.init_neat(jax.random.PRNGKey(5), cfg_j)
    model = port_model(params, cfg_t)
    rs = np.random.RandomState(1)
    (zj, ej), (zt, et) = _run_both(
        lambda p: jmlp.implicit_sdf(params["implicit"], p, cfg_j.implicit)[..., 0],
        lambda p: tmlp.implicit_sdf(model.implicit, p, cfg_t.implicit)[..., 0],
        rs, True,
    )
    # the net's f32 products sum in another order (~1e-6 relative); the
    # inverse CDF divides by small cdf steps, so allow 5e-4 absolute on z
    np.testing.assert_allclose(zt, zj, rtol=1e-4, atol=5e-4)
    np.testing.assert_allclose(et, ej, rtol=1e-4, atol=5e-4)


def test_sample_pdf_and_d_star():
    rs = np.random.RandomState(2)
    bins = np.sort(rs.rand(6, 20).astype(np.float32) * 4, axis=-1)
    w = rs.rand(6, 19).astype(np.float32)
    w[:, 5:9] = 0.0  # cdf plateaus
    u = rs.rand(6, 10).astype(np.float32)
    a = ts.sample_pdf(t(bins), t(w), 10, u=t(u))
    b = js.sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), 10, u=jnp.asarray(u))
    np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-6, atol=1e-6)
    sdf = rs.randn(6, 20).astype(np.float32)
    np.testing.assert_allclose(
        n(ts._d_star(t(bins), t(sdf))), np.asarray(js._d_star(jnp.asarray(bins), jnp.asarray(sdf))),
        rtol=1e-6, atol=1e-6,
    )
