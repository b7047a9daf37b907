"""The wfr family (neat_wfr, neat_wfr_a, neat_simple) and the dual-batch
class against neat_tpu: one f64 step each, the eval-mode forward of
neat_wfr and neat_simple (the attraction re-evaluated at l3d), and the
dual class's two batches drawn from one view. Tolerances and set-up:
tests/test_torch_variants.py."""

import numpy as np
import pytest
import torch

import _variants as V
from _torch_helpers import one_thread, t


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.fixture(scope="module", params=["wfr", "wfr_a", "simple", "dual"])
def stepped(request):
    return V.stepped(request.param)


def test_class_maps_to_its_flags(stepped):
    V.check_class_flags(stepped)


def test_one_train_step_matches_jax(stepped):
    V.check_one_train_step(stepped)


@pytest.mark.parametrize("key", ["wfr", "simple"])
def test_eval_forward_matches_jax(key):
    V.check_eval_forward(key)


def test_dual_batch_draws_both_batches_from_one_view():
    """The dual-batch step draws its view once and hands it to the support
    batch and to the uniform batch, whose junctions are all masked; the
    uniform pass's auction and the support pass's run on it (one step on
    the port's own draws, several seeds so both views come up)."""
    _, et = V.class_configs("dual")
    cfg_t = et.model
    scene = {k: t(v) for k, v in V._scene(cfg_t, "dual").items()}
    seen = []
    orig_s, orig_u = V.tstep.sample_batch, V.tstep.sample_uniform_batch

    def support(gen, sc, n_rays, width, view=None):
        seen.append(("support", view))
        return orig_s(gen, sc, n_rays, width, view=view)

    def uniform(gen, sc, n_rays, width, view):
        inputs, gt = orig_u(gen, sc, n_rays, width, view)
        assert not bool(inputs["verts_mask"].any()) and torch.equal(inputs["uv"], inputs["uv_proj"])
        seen.append(("uniform", view))
        return inputs, gt

    V.tstep.sample_batch, V.tstep.sample_uniform_batch = support, uniform
    try:
        model = V.tneat.init_neat(cfg_t, seed=0, device="cpu")
        step = V.tstep.make_train_step(cfg_t, et.loss, V.LR, V.DECAY, V.DECAY_STEPS, V.N_RAYS, V.RES)
        state = V.tstep.init_train_state(model)
        for seed in range(4):
            state, m = step(state, scene, torch.Generator().manual_seed(seed))
            assert np.isfinite(float(m["loss"]))
    finally:
        V.tstep.sample_batch, V.tstep.sample_uniform_batch = orig_s, orig_u
    assert [kind for kind, _ in seen] == ["support", "uniform"] * 4
    pairs = [(seen[2 * i][1], seen[2 * i + 1][1]) for i in range(4)]
    assert all(a == b for a, b in pairs) and len({a for a, _ in pairs}) == 2, pairs


