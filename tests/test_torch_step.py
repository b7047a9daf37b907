"""The port's training step against neat_tpu's make_train_step.

Both start from the same init_neat weights. The port is handed the JAX
step's own batch and noise, rebuilt from its keys: the batch with
sample_batch under train/step.py's key splits, the noise with
draw_forward_noise(r_fwd, R, cfg), which neat.py guarantees equals the
forward's internal draws. 12 rays at narrow widths in f32; JAX on its XLA
paths, the port with its kernel flags on (plain versions on CPU).

Tolerances: losses to 1e-4 relative. Parameters: every entry of every leaf
to 1e-5, 50x below lr = 5e-4, the size of one early Adam update, so a leaf
with a wrong or zero gradient fails. The two packages' gradients differ by
f32 noise of about 1e-5 of each leaf's largest entry. Adam's update
lr * g / (|g| + eps) hides that wherever |g| is well above it, and here no
entry's gradient is so small that it moves the other way: the worst entry
after 3 steps differs by about 2e-6, so none is exempt.
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

LR, DECAY, DECAY_STEPS = 5e-4, 0.1, 1000
N_RAYS, RES = 12, 32
KERNEL_FLAGS = dict(use_pallas_sampler=True, use_pallas_field=True, pallas_field_backward="stash")


@pytest.fixture(scope="module")
def trajectories():
    """Losses and parameters after each of 3 steps, for both packages."""
    cfg_j, cfg_t = configs(sampler_compute_dtype="float32")
    cfg_t = dataclasses.replace(cfg_t, **KERNEL_FLAGS)
    params = jneat.init_neat(jax.random.PRNGKey(3), cfg_j)
    model = port_model(params, cfg_t)
    scene = small_scene(cfg_j)

    state_j = jstep.init_train_state(params, LR, DECAY, DECAY_STEPS)
    step_j = jstep.make_train_step(
        cfg_j, jloss.LossConfig(), LR, DECAY, DECAY_STEPS, N_RAYS, RES, donate=False
    )
    state_t = tstep.init_train_state(model)
    step_t = tstep.make_train_step(cfg_t, tloss.LossConfig(), LR, DECAY, DECAY_STEPS, N_RAYS, RES)
    rng = jax.random.PRNGKey(11)
    out = []
    for s in range(3):
        r_batch, r_fwd = jax.random.split(jax.random.fold_in(rng, s))
        inputs, gt = to_numpy(jstep.sample_batch(r_batch, scene, N_RAYS, RES))
        noise = to_numpy(jneat.draw_forward_noise(r_fwd, N_RAYS, cfg_j))
        state_j, m_j = step_j(state_j, scene, rng)
        batch = ({k: t(v) for k, v in inputs.items()}, {k: t(v) for k, v in gt.items()})
        state_t, m_t = step_t(state_t, None, batch=batch, noise={k: t(v) for k, v in noise.items()})
        out.append((
            float(m_j["loss"]), float(m_t["loss"]),
            params_from_jax(to_numpy(state_j.params)),
            {k: v.detach().clone() for k, v in state_t.model.state_dict().items()},
        ))
    return out


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax(trajectories, n_steps):
    for s in range(n_steps):
        loss_j, loss_t, p_j, p_t = trajectories[s]
        np.testing.assert_allclose(loss_t, loss_j, rtol=1e-4, err_msg=f"loss after step {s + 1}")
    _, _, p_j, p_t = trajectories[n_steps - 1]
    assert set(p_t) == set(p_j)
    worst = {k: float(np.abs(n(p_t[k]) - p_j[k].numpy()).max()) for k in p_j}
    bad = {k: v for k, v in worst.items() if v > 1e-5}
    assert not bad, f"parameters off after {n_steps} steps: {bad}"


def test_lr_schedule_and_adam_count():
    """optax.exponential_decay semantics: the count is 0 at the first update."""
    sched = jstep.make_lr_schedule(LR, DECAY, DECAY_STEPS)
    for c in (0, 1, 500, 2000):
        np.testing.assert_allclose(tstep.lr_schedule(LR, DECAY, DECAY_STEPS, c), float(sched(c)), rtol=1e-6)
