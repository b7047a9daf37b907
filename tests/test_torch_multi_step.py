"""The port's make_train_multi_step (a plain loop of K steps) against
neat_tpu's (a lax.scan of K steps), and against the port's own steps one
by one.

Both packages start from the same init_neat weights at tests/
test_torch_step.py's narrow widths, f32, JAX on its XLA paths and the port
with its kernel flags on (plain versions on the CPU). The JAX scan runs 3
steps on keys split from one key; the port's loop is handed the scan's own
batch and noise for each step, rebuilt from those keys as
train/step.py splits them (fold_in(key, state.step), then batch and
forward keys). Tolerances are tests/test_torch_step.py's for sequential
steps: each step's loss to 1e-4 relative, every parameter entry to 1e-5
after the 3 steps.

The port's loop against its own steps one by one on the same draws:
parameters, Adam moments, step count and every step's metrics bit for bit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import neat_tpu.model.loss as jloss
import neat_tpu.model.neat as jneat
import neat_tpu.train.step as jstep
import neat_tpu_torch.model.loss as tloss
import neat_tpu_torch.train.step as tstep
from _torch_helpers import configs, n, port_model, small_scene, t, to_numpy
from neat_tpu_torch.interop import params_from_jax
from neat_tpu_torch.train.checkpoint import host_state

LR, DECAY, DECAY_STEPS = 5e-4, 0.1, 1000
N_RAYS, RES, K = 12, 32, 3
KERNEL_FLAGS = dict(use_pallas_sampler=True, use_pallas_field=True, pallas_field_backward="stash")


@pytest.fixture(scope="module")
def setup():
    cfg_j, cfg_t = configs(sampler_compute_dtype="float32")
    cfg_t = dataclasses.replace(cfg_t, **KERNEL_FLAGS)
    params = jneat.init_neat(jax.random.PRNGKey(3), cfg_j)
    return cfg_j, cfg_t, params, small_scene(cfg_j)


@pytest.fixture(scope="module")
def jax_scan(setup):
    """The JAX scan's state after K steps, its stacked metrics, and each
    step's (batch, noise) as numpy."""
    cfg_j, _, params, scene = setup
    multi = jstep.make_train_multi_step(cfg_j, jloss.LossConfig(), LR, DECAY, DECAY_STEPS, N_RAYS, RES, donate=False)
    state = jstep.init_train_state(params, LR, DECAY, DECAY_STEPS)
    keys = jax.random.split(jax.random.PRNGKey(11), K)
    draws = []
    for s in range(K):  # the scan's step s sees state.step == s
        r_batch, r_fwd = jax.random.split(jax.random.fold_in(keys[s], s))
        draws.append((to_numpy(jstep.sample_batch(r_batch, scene, N_RAYS, RES)),
                      to_numpy(jneat.draw_forward_noise(r_fwd, N_RAYS, cfg_j))))
    state, metrics = multi(state, scene, keys)
    return to_numpy(state.params), int(state.step), to_numpy(metrics), draws


def _port_inputs(draws):
    batches = [({k: t(v) for k, v in inputs.items()}, {k: t(v) for k, v in gt.items()})
               for (inputs, gt), _ in draws]
    noises = [{k: t(v) for k, v in noise.items()} for _, noise in draws]
    return batches, noises


@pytest.fixture(scope="module")
def port_multi(setup, jax_scan):
    """The port's loop handed the scan's draws: (state, stacked metrics)."""
    _, cfg_t, params, _ = setup
    multi = tstep.make_train_multi_step(cfg_t, tloss.LossConfig(), LR, DECAY, DECAY_STEPS, N_RAYS, RES)
    batches, noises = _port_inputs(jax_scan[3])
    return multi(tstep.init_train_state(port_model(params, cfg_t)), None, batches=batches, noises=noises)


def test_multi_step_matches_the_jax_scan(jax_scan, port_multi):
    p_j, step_j, m_j, _ = jax_scan
    state, m_t = port_multi
    assert state.step == step_j == K
    assert set(m_t) == set(m_j) and all(v.shape == (K,) for v in m_t.values())
    np.testing.assert_allclose(n(m_t["loss"]), m_j["loss"], rtol=1e-4)
    ref = params_from_jax(p_j)
    got = state.model.state_dict()
    assert set(got) == set(ref)
    worst = {k: float(np.abs(n(got[k]) - ref[k].numpy()).max()) for k in ref}
    bad = {k: v for k, v in worst.items() if v > 1e-5}
    assert not bad, f"parameters off after {K} steps: {bad}"


def test_multi_step_equals_the_steps_one_by_one(setup, jax_scan, port_multi):
    """The loop against make_train_step called K times on the same draws.
    (Through the runner, on the steps' own generators:
    tests/test_torch_runner.py::test_epoch_scan_equals_the_steps_one_by_one.)"""
    _, cfg_t, params, _ = setup
    step = tstep.make_train_step(cfg_t, tloss.LossConfig(), LR, DECAY, DECAY_STEPS, N_RAYS, RES)
    batches, noises = _port_inputs(jax_scan[3])
    one = tstep.init_train_state(port_model(params, cfg_t))
    seq = []
    for batch, noise in zip(batches, noises):
        one, m = step(one, None, batch=batch, noise=noise)
        seq.append(m)
    many, stacked = port_multi
    a, b = host_state(one), host_state(many)
    assert a["step"] == b["step"] == K
    for part in ("params", "mu", "nu"):
        assert all(a[part][k].tobytes() == b[part][k].tobytes() for k in a[part]), part
    for key, v in stacked.items():
        assert torch.equal(v, torch.stack([m[key] for m in seq])), key
