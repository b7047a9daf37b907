"""Why phase 8 of chip_smoke.py holds each f32 route against its f64
shadow (``chip_smoke.SamplerTape``) and not against an f64 run on its own
decisions: the error-bounded sampler at abc-neat-a's settings (128
proposals a round, 5 rounds) on trained weights.

The weights are tests/data/finalize_trained/params.npz (trained; their
density's beta is 3e-4), the rays one chunk of view 0's support pixels.
On such a field the refinement pdf is exactly 0 in f32 over more leading
intervals than in f64 (``exp(err_int) - 1`` below f32's epsilon,
``exp(-d*/beta)`` underflowing), so the draw at u = 0 of each refinement
round lands elsewhere, the proposals' ranks shift and the extra samples
taken by rank move: the median ray's z is a step of the 128-sample grid
or more off the f64 run, in the JAX package's f32 sampler as in the
port's, while the two f32 samplers are within a tenth of that step of each
other. Under a SamplerTape the f64 model samples as the f32 run did (its
decisions, its f32 bookkeeping) and differs from it by the network's
rounding alone; recording leaves the f32 run bit for bit its own.
"""

import contextlib
import copy
import dataclasses
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import neat_tpu.sampling.samplers as js
import neat_tpu_torch.model.neat as tneat
import neat_tpu_torch.wireframe.finalize as tfin
from _torch_helpers import one_thread, port_model
from neat_tpu.fields.mlp import implicit_sdf as j_implicit_sdf
from test_torch_finalize_trained import DATA_DIR, FIXTURE, SCENE, fixture_params

TOY_CONF = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "confs", "abc-neat-a.conf")
RAYS = 256  # one chunk of view 0's support pixels
GRID_STEP = 1.0 / 127  # a step of the 128-sample grid over [0, 2R], as a share of the largest z
OUTPUTS = ("z", "lines3d", "lines2d", "l3d")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


def _toy_sampler(cfg, sampler):
    """cfg with abc-neat-a's sampler settings."""
    keep = {f: getattr(sampler, f) for f in ("n_samples", "n_samples_eval", "n_samples_extra", "max_total_iters")}
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, sampler=dataclasses.replace(
        cfg.model.sampler, **keep)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """view_field_lines of RAYS rays of view 0 on the port's plain f32
    route (plain and recording), the f64 model as its shadow and sampling
    on its own, and the JAX package's f32 sampler on the f32 route's rays:
    {name: {output: per-ray tensor}}."""
    from neat_tpu.train.config import load_experiment_config as jload
    from neat_tpu_torch.data.datasets import load_scene_for_config
    from neat_tpu_torch.data.synthetic import generate_scene
    from neat_tpu_torch.train.config import load_experiment_config as tload

    root = str(tmp_path_factory.mktemp("sampler_shadow"))
    generate_scene(osp.join(root, DATA_DIR), **SCENE)
    conf = osp.join(FIXTURE, "runconf.conf")
    cfg_j = _toy_sampler(jload(conf), jload(TOY_CONF).model.sampler)
    cfg_t = _toy_sampler(tload(conf), tload(TOY_CONF).model.sampler)
    assert cfg_t.model.sampler.n_samples_eval == 128 and cfg_t.model.sampler.max_total_iters == 5
    params = fixture_params(cfg_j.model)
    scene = load_scene_for_config(cfg_t, root, distance_threshold=1.0)
    mask = np.zeros_like(scene.mask[0])
    mask[np.nonzero(scene.mask[0])[0][:RAYS]] = True
    m32 = port_model(params, cfg_t.model)
    m64 = copy.deepcopy(m32).double()

    orig_forward, orig_sampler = tneat.neat_forward, tneat.error_bound_z_vals
    rays = []

    def sampler(ray_dirs, cam_loc, *a, **k):
        if ray_dirs.dtype == torch.float32 and not rays:
            rays.append((ray_dirs.clone(), cam_loc.clone()))
        return orig_sampler(ray_dirs, cam_loc, *a, **k)

    def run(model, taped=None):
        zs = []

        def forward(*a, **k):
            res = orig_forward(*a, **k)
            zs.append(res["z_vals"])
            return res

        tneat.neat_forward, tneat.error_bound_z_vals = forward, sampler
        try:
            with taped() if taped is not None else contextlib.nullcontext():
                l3, l2, lp, _ = tfin.view_field_lines(model, cfg_t.model, scene, 0, RAYS, mask_override=mask,
                                                      kernels=False)
        finally:
            tneat.neat_forward, tneat.error_bound_z_vals = orig_forward, orig_sampler
        return {"z": torch.cat(zs)[: l3.shape[0]], "lines3d": torch.from_numpy(l3),
                "lines2d": torch.from_numpy(l2), "l3d": torch.from_numpy(lp)}

    tape = chip_smoke.SamplerTape()
    out = {"f32": run(m32), "f32_recorded": run(m32, tape.recording)}
    out["f64_shadow"] = run(m64, tape.shadowing)
    out["f64_own"] = run(m64)
    out["replayed"] = (tape.pos, len(tape.kept))

    d, c = rays[0]
    sdf_fn = lambda p: j_implicit_sdf(params["implicit"], p, cfg_j.model.implicit)[..., 0]
    zj, _ = jax.jit(lambda d, c: js.error_bound_z_vals(
        jax.random.PRNGKey(0), d, c, sdf_fn, params["density"], cfg_j.model.sampler, False,
        beta_min=cfg_j.model.density_beta_min))(jnp.asarray(d.numpy()), jnp.asarray(c.numpy()))
    out["jax_f32"] = {"z": torch.from_numpy(np.array(zj))}
    return out


def test_f32_samplers_agree_and_f64_on_its_own_decisions_is_grid_steps_off(runs):
    port, jax_z, own = runs["f32"]["z"], runs["jax_f32"]["z"], runs["f64_own"]["z"]
    assert port.shape == jax_z.shape == own.shape == (RAYS, 64 + 32 + 2)
    for z in (port, jax_z):
        assert float(chip_smoke._ray_err(z, own).median()) >= GRID_STEP * (1 - 1e-3)
    assert float(chip_smoke._ray_err(port, jax_z).median()) < GRID_STEP / 10


def test_recording_leaves_f32_bit_for_bit(runs):
    for key in OUTPUTS:
        assert torch.equal(runs["f32"][key], runs["f32_recorded"][key]), key
    pos, kept = runs["replayed"]
    assert pos == kept > 0


def test_f64_shadow_differs_from_f32_by_rounding(runs):
    f32, shadow, own = runs["f32"], runs["f64_shadow"], runs["f64_own"]
    for key in OUTPUTS:
        e_shadow, e_own = chip_smoke._ref_err(f32[key], shadow[key]), chip_smoke._ref_err(f32[key], own[key])
        assert float(e_shadow.median()) <= chip_smoke.FIN_TOL, key
        assert int((e_shadow > chip_smoke.FIN_TOL).sum()) <= int((e_own > chip_smoke.FIN_TOL).sum()), key
    z_shadow, z_own = chip_smoke._ref_err(f32["z"], shadow["z"]), chip_smoke._ref_err(f32["z"], own["z"])
    assert int((z_shadow > chip_smoke.FIN_TOL).sum()) < int((z_own > chip_smoke.FIN_TOL).sum()) // 10
