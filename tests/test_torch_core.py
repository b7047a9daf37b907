"""neat_tpu_torch.core against neat_tpu.core on the same arrays, in f32 and f64.

Tolerances: the two frameworks run the same elementwise formulas, so f32
agrees to a few ulps (rtol 2e-6) and f64 to 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neat_tpu.core as jc
import neat_tpu_torch.core as tc
from neat_tpu.core.density import LaplaceDensityParams
from neat_tpu.core.render import alpha_transmittance as j_alpha_transmittance

TOL = {np.float32: dict(rtol=2e-6, atol=1e-6), np.float64: dict(rtol=1e-12, atol=1e-12)}


class _Beta:
    def __init__(self, beta):
        self.beta = beta


def _cam(rs, dtype):
    k = np.eye(4)
    k[0, 0], k[1, 1], k[0, 2], k[1, 2], k[0, 1] = 560.0, 540.0, 256.0, 250.0, 0.3
    ang = rs.randn(3) * 0.3
    c, s = np.cos(ang), np.sin(ang)
    rz = np.array([[c[0], -s[0], 0], [s[0], c[0], 0], [0, 0, 1]])
    rx = np.array([[1, 0, 0], [0, c[1], -s[1]], [0, s[1], c[1]]])
    pose = np.eye(4)
    pose[:3, :3] = rz @ rx
    pose[:3, 3] = rs.randn(3) + [0, 0, -2.5]
    return k.astype(dtype), pose.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_core_functions_match(dtype):
    rs = np.random.RandomState(0)
    tol = TOL[dtype]
    with jax.enable_x64(dtype == np.float64):
        x = (rs.randn(50, 3) * 2).astype(dtype)
        np.testing.assert_allclose(
            tc.positional_encoding(torch.as_tensor(x), 6).numpy(),
            np.asarray(jc.positional_encoding(jnp.asarray(x), 6)), **tol,
        )
        assert tc.encoding_dim(6, 3) == jc.encoding_dim(6, 3) == 39

        sdf = (rs.randn(8, 40) * 0.3).astype(dtype)
        beta = np.asarray(-0.07, dtype)
        jb = LaplaceDensityParams(beta=jnp.asarray(beta))
        tb = _Beta(torch.as_tensor(beta))
        np.testing.assert_allclose(float(tc.get_beta(tb, 1e-4)), float(jc.get_beta(jb, 1e-4)), **tol)
        dens_t = tc.laplace_density(torch.as_tensor(sdf), tb, beta_min=1e-4)
        dens_j = jc.laplace_density(jnp.asarray(sdf), jb, beta_min=1e-4)
        np.testing.assert_allclose(dens_t.numpy(), np.asarray(dens_j), **tol)

        z = np.sort(rs.rand(8, 40) * 6, axis=-1).astype(dtype)
        np.testing.assert_allclose(
            tc.render_weights_from_density(torch.as_tensor(z), dens_t).numpy(),
            np.asarray(jc.render_weights_from_density(jnp.asarray(z), dens_j)), **tol,
        )
        for a, b in zip(
            tc.alpha_transmittance(torch.as_tensor(z), dens_t),
            j_alpha_transmittance(jnp.asarray(z), dens_j),
        ):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)

        k, pose = _cam(rs, dtype)
        uv = (rs.rand(1, 30, 2) * 512).astype(dtype)
        for p in (pose, np.concatenate([[0.9, 0.1, -0.2, 0.3], pose[:3, 3]]).astype(dtype)):
            dt, lt = tc.get_camera_params(torch.as_tensor(uv), torch.as_tensor(p)[None], torch.as_tensor(k)[None])
            dj, lj = jc.get_camera_params(jnp.asarray(uv), jnp.asarray(p)[None], jnp.asarray(k)[None])
            np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **tol)
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **tol)
        lifted_t = tc.lift(*(torch.as_tensor(a) for a in (uv[..., 0], uv[..., 1], np.ones_like(uv[..., 0]), k[None])))
        lifted_j = jc.lift(jnp.asarray(uv[..., 0]), jnp.asarray(uv[..., 1]), jnp.ones_like(uv[..., 0]), jnp.asarray(k)[None])
        np.testing.assert_allclose(lifted_t.numpy(), np.asarray(lifted_j), **tol)

        w2c = np.linalg.inv(pose)
        pts = (rs.randn(7, 2, 3)).astype(dtype)
        args = (k[:3, :3], w2c[:3, :3], w2c[:3, 3], pts)
        np.testing.assert_allclose(
            tc.project2d(*(torch.as_tensor(a) for a in args)).numpy(),
            np.asarray(jc.project2d(*(jnp.asarray(a) for a in args))), **tol,
        )

        cam = np.tile(pose[:3, 3], (30, 1)).astype(dtype)
        dirs = rs.randn(30, 3).astype(dtype)
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)  # some rays miss the sphere
        np.testing.assert_allclose(
            tc.get_sphere_intersections(torch.as_tensor(cam), torch.as_tensor(dirs), 1.5).numpy(),
            np.asarray(jc.get_sphere_intersections(jnp.asarray(cam), jnp.asarray(dirs), 1.5)), **tol,
        )

        a, b = rs.rand(16, 3).astype(dtype), rs.rand(16, 3).astype(dtype)
        np.testing.assert_allclose(
            float(tc.psnr(torch.as_tensor(a), torch.as_tensor(b))), float(jc.psnr(jnp.asarray(a), jnp.asarray(b))),
            rtol=1e-5 if dtype == np.float32 else 1e-12,
        )
