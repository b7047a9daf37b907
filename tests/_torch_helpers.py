"""Shared set-up for the tests that hold neat_tpu_torch against neat_tpu.

Both packages are built from the same keyword arguments; weights move from
the JAX parameter tree to the port through ``interop.params_from_jax`` as
numpy arrays.
"""

import dataclasses

import jax
import numpy as np
import torch

import neat_tpu.fields.mlp as jmlp
import neat_tpu.model.neat as jneat
import neat_tpu.sampling.samplers as jsamp
import neat_tpu_torch.fields.mlp as tmlp
import neat_tpu_torch.model.neat as tneat
import neat_tpu_torch.sampling.samplers as tsamp
from neat_tpu_torch.interop import params_from_jax

# narrow widths with the canonical layer structure (9 implicit layers, skip
# at 4, multires 6; 5-layer idr heads), so the fused field math applies
NARROW = dict(
    feature_vector_size=32,
    implicit=dict(dims=(64,) * 8, skip_in=(4,), multires=6, feature_vector_size=32),
    rendering=dict(dims=(64,) * 4, multires_view=4, feature_vector_size=32),
    attraction=dict(dims=(64,) * 4, d_out=6, multires_view=0, feature_vector_size=32),
    junctions=dict(num_junctions=16, dim_hidden=32),
    sampler=dict(n_samples=16, n_samples_eval=32, n_samples_extra=8, max_total_iters=3),
    max_verts=16,
)


def configs(spec=NARROW, **flags):
    """(jax NeatConfig, torch NeatConfig) from the same kwargs."""

    def build(mlp, samp, neat):
        kw = dict(
            feature_vector_size=spec["feature_vector_size"],
            implicit=mlp.ImplicitNetConfig(**spec["implicit"]),
            rendering=mlp.RenderNetConfig(**spec["rendering"]),
            attraction=mlp.RenderNetConfig(**spec["attraction"]),
            junctions=mlp.GlobalJunctionsConfig(**spec["junctions"]),
            sampler=samp.ErrorBoundSamplerConfig(**spec["sampler"]),
            max_verts=spec["max_verts"],
        )
        return dataclasses.replace(neat.NeatConfig.for_abc(), **kw, **flags)

    return build(jmlp, jsamp, jneat), build(tmlp, tsamp, tneat)


def small_scene(cfg, res=32, n_views=2, l_max=12, n_verts=10, seed=0):
    """A packed scene in train/step.py's layout (numpy), small enough for
    CPU steps: a camera 2 units back on -z looking at the origin."""
    rs = np.random.RandomState(seed)
    hw = res * res
    k = np.eye(4, dtype=np.float32)
    k[0, 0] = k[1, 1] = 1.1 * res
    k[0, 2] = k[1, 2] = res / 2
    poses = np.tile(np.eye(4, dtype=np.float32), (n_views, 1, 1))
    poses[:, 2, 3] = -2.0
    poses[:, 0, 3] = np.linspace(-0.2, 0.2, n_views)
    verts_mask = np.zeros((n_views, cfg.max_verts), bool)
    verts_mask[:, :n_verts] = True
    return {
        "rgb": rs.rand(n_views, hw, 3).astype(np.float32),
        "intrinsics": np.tile(k, (n_views, 1, 1)),
        "pose": poses,
        "mask": np.ones((n_views, hw), dtype=bool),
        "labels": rs.randint(0, l_max, (n_views, hw)).astype(np.int32),
        "uv_proj": (rs.rand(n_views, hw, 2) * res).astype(np.float32),
        "lines": (rs.rand(n_views, l_max, 5) * res).astype(np.float32),
        "verts2d": (rs.rand(n_views, cfg.max_verts, 2) * res).astype(np.float32),
        "verts_mask": verts_mask,
        "support_idx": np.tile(np.arange(hw, dtype=np.int32), (n_views, 1)),
        "support_count": np.full((n_views,), hw, dtype=np.int32),
    }


def to_numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def port_model(jax_params, cfg_t, dtype=torch.float32):
    model = tneat.init_neat(cfg_t, device="cpu")
    model.load_state_dict(params_from_jax(to_numpy(jax_params)), strict=True)
    return model.to(dtype)


def t(a, dtype=None):
    """numpy/jax array -> torch tensor (optionally cast)."""
    x = torch.as_tensor(np.array(a))
    return x if dtype is None else x.to(dtype)


def n(x):
    """torch tensor -> numpy."""
    return x.detach().cpu().numpy()
