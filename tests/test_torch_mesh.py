"""The port's numpy-only copies against the JAX package's: utils/chunking.py
(split_input, merge_output) and the rest of viz/mesh.py (grid_sample_mesh,
sample_mesh_surface with a shared seed). Tolerance 0: the same numpy calls
give the same arrays bit for bit (marching_tetrahedra, largest_component,
save_ply and load_ply: tests/test_torch_render_eval.py)."""

import numpy as np
import pytest

import neat_tpu.utils.chunking as jchunk
import neat_tpu.viz.mesh as jmesh
import neat_tpu_torch.utils.chunking as tchunk
import neat_tpu_torch.viz.mesh as tmesh


@pytest.mark.parametrize("total,n_pixels,pad", [(10, 4, True), (10, 4, False), (12, 4, True), (3, 8, True), (1, 1, True)])
def test_chunking_equals_jax(total, n_pixels, pad):
    rs = np.random.RandomState(total)
    inputs = {"uv": rs.rand(total, 2).astype(np.float32), "uv_proj": rs.rand(total, 2), "pose": np.eye(4),
              "other": rs.rand(total, 3)}
    want = jchunk.split_input(inputs, total, n_pixels=n_pixels, pad=pad)
    got = tchunk.split_input(inputs, total, n_pixels=n_pixels, pad=pad)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    outs = [{"x": c["uv"] * 2, "y": c["uv_proj"].sum(-1), "_valid": c["_valid"]} for c in got]
    for a, b in zip(tchunk.merge_output(outs, total).values(), jchunk.merge_output(outs, total).values()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tchunk.merge_output(outs, total)["x"], inputs["uv"] * 2)


def _mesh(seed):
    verts, faces = jmesh.sdf_to_mesh(
        lambda p: (np.linalg.norm(p + 0.1 * seed, axis=-1) - 0.7).astype(np.float32), resolution=12)
    return verts, faces


@pytest.mark.parametrize("density", [0.05, 0.2, 1.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_grid_sample_mesh_equals_jax(seed, density):
    verts, faces = _mesh(seed)
    want = jmesh.grid_sample_mesh(verts, faces, density=density)
    got = tmesh.grid_sample_mesh(verts, faces, density=density)
    assert got.dtype == want.dtype and got.shape[0] >= verts.shape[0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tmesh.grid_sample_mesh(verts, faces[:0]), verts)


@pytest.mark.parametrize("n_points", [1, 500])
@pytest.mark.parametrize("seed", [0, 7])
def test_sample_mesh_surface_equals_jax(seed, n_points):
    verts, faces = _mesh(seed)
    want = jmesh.sample_mesh_surface(verts, faces, n_points, seed=seed)
    got = tmesh.sample_mesh_surface(verts, faces, n_points, seed=seed)
    assert got.shape == (n_points, 3)
    np.testing.assert_array_equal(got, want)
