"""The fused sampler round (K4) of the port through its plain version, the
grid beta search, and the two training steps this slice adds, against
neat_tpu.

* ``fused_round_plain`` against the Pallas round kernel in interpret mode
  on ``tests/test_ops.py::TestFusedSamplerRound._data``'s recipe, ``refine``
  both ways: rtol 2e-4 / atol 2e-5, that test's own limits. Both are f32;
  the kernel's prefix sums are log-step shifted adds, the plain version's
  ``torch.cumsum``, so an ``err <= eps`` decision within an ulp of the knife
  edge may flip (none does on this data).
* the same with the CUDA kernel's order of summation put into the plain
  version (each thread's samples in turn, a Hillis-Steele scan over each
  warp's 32 lanes, the earlier warps' totals in turn, the thread's samples
  again; the pdf's sum a thread's samples, five xor steps in the warp, then
  the four warps' sums pairwise) at the five widths the sampler hands the
  kernel, each with the ``refine`` it runs with: rays whose beta differs by
  more than 2e-4 relative (one flipped decision) may be 0.5% of the rays,
  the others hold to rtol 2e-4 / atol 2e-5, ``chip_smoke.py``'s ``K4_*``
  limits.
* the special-function count of the kernel's bound, and the rays whose
  beta0 check passes (one evaluation of the bound, not 11).
* ``error_bound_z_vals`` with ``fused_rounds='on'`` (CPU: the plain round)
  against the JAX sampler with ``fused_rounds='interpret'`` on the same
  noise, and a shape the guard turns away against the unfused path.
* the ``grid`` beta search against the JAX one on the same noise. The
  limits on z stand beside each comparison.
* one training step with ``pallas_field_backward='recompute'`` and one with
  ``fused_rounds='on'`` against ``make_train_step``, as test_torch_step.py
  holds the stash step: loss to 1e-4 relative, every parameter entry to 1e-5
  (50x below one Adam update of lr = 5e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neat_tpu.model.loss as jloss
import neat_tpu.model.neat as jneat
import neat_tpu.ops.fused_round as jfr
import neat_tpu.sampling.samplers as js
import neat_tpu.train.step as jstep
import neat_tpu_torch.model.loss as tloss
import neat_tpu_torch.ops.fused_round as tfr
import neat_tpu_torch.sampling.samplers as ts
import neat_tpu_torch.train.step as tstep
from _torch_helpers import NARROW, configs, n, port_model, small_scene, t, to_numpy
from neat_tpu.core.density import LaplaceDensityParams
from neat_tpu_torch.core.density import LaplaceDensity
from neat_tpu_torch.interop import params_from_jax

ROUND = dict(eps=0.1, beta_iters=10, add_tiny=0.0)


def _round_data(r=128, s=256, seed=0):
    rng = np.random.RandomState(seed)
    z = np.sort(rng.uniform(0.0, 6.0, size=(r, s)).astype(np.float32), axis=1)
    # SDF of rays crossing a unit sphere-ish surface: smooth, sign changes
    sdf = (np.abs(z - 3.0) - 1.5 + 0.3 * rng.randn(r, s)).astype(np.float32)
    beta = rng.uniform(0.05, 0.5, size=(r,)).astype(np.float32)
    return z, sdf, beta


@pytest.mark.parametrize("refine", [True, False])
def test_round_plain_matches_interpret_kernel(refine):
    z, sdf, beta = _round_data()
    beta0 = np.float32(2e-3 + 1e-4)
    bj, wj, pj = jfr.fused_sampler_round(
        jnp.asarray(z), jnp.asarray(sdf), jnp.asarray(beta), jnp.asarray(beta0),
        refine=refine, interpret=True, **ROUND,
    )
    bt, wt, pt = tfr.fused_sampler_round(t(z), t(sdf), t(beta), torch.tensor(beta0), refine=refine, **ROUND)
    assert bt.shape == (128,) and wt.shape == pt.shape == (128, 256)
    np.testing.assert_allclose(n(bt), np.asarray(bj), rtol=2e-4)
    np.testing.assert_allclose(n(wt), np.asarray(wj), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(n(pt), np.asarray(pj), rtol=2e-4, atol=2e-5)
    assert np.all(n(pt)[:, -1] == 0.0)
    if refine:
        np.testing.assert_allclose(n(pt).sum(-1), 1.0, rtol=1e-5)
    else:
        assert np.all(n(pt) == 0.0)


def _block_lanes(a):
    """(R, S) -> (R, 4, 32, S / 128): lane l of warp w of the ray's 128-thread
    block holds samples t * S / 128 ... (t + 1) * S / 128 - 1, t = 32 w + l."""
    return a.reshape(a.shape[0], 4, 32, -1)


def _lane_totals(x):
    tot = x[..., 0]
    for k in range(1, x.shape[-1]):
        tot = tot + x[..., k]
    return tot


def _block_prefix(a, inclusive):
    """Prefix sums along each row in the kernel's order: each thread's
    samples in turn, a Hillis-Steele scan of the thread totals over each
    warp's 32 lanes, one lane down, the earlier warps' totals added in turn
    in front of it, then the thread's samples again from there."""
    x = _block_lanes(a)
    tot = _lane_totals(x)
    lane = torch.arange(32)
    for o in (1, 2, 4, 8, 16):
        shifted = torch.cat([torch.zeros_like(tot[..., :o]), tot[..., :-o]], dim=-1)
        tot = torch.where(lane >= o, tot + shifted, tot)
    in_warp = torch.cat([torch.zeros_like(tot[..., :1]), tot[..., :-1]], dim=-1)
    before = [torch.zeros_like(tot[:, 0, 0])]
    for w in range(3):
        before.append(before[-1] + tot[:, w, 31])
    run = torch.stack(before, dim=1)[..., None] + in_warp
    out = []
    for k in range(x.shape[-1]):
        if not inclusive:
            out.append(run)
        run = run + x[..., k]
        if inclusive:
            out.append(run)
    return torch.stack(out, dim=-1).reshape(a.shape)


def _block_row_sum(a):
    """Each row's sum in the kernel's order: a thread's samples, five
    xor-shuffle steps in each warp, then the warps' sums (0 + 1) + (2 + 3)."""
    tot = _lane_totals(_block_lanes(a))
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        tot = tot + tot[..., lane ^ o]
    w = tot[..., 0]
    return ((w[:, 0] + w[:, 1]) + (w[:, 2] + w[:, 3]))[:, None]


# chip_smoke.py's K4 limits: a flipped decision moves beta by more than this
K4_BETA_RTOL, K4_RTOL, K4_ATOL, K4_MAX_FLIPPED = 2e-4, 2e-4, 2e-5, 0.005


@pytest.mark.parametrize("lanes", [128, 256, 384, 512, 640])
def test_round_in_the_warp_kernels_order_matches_interpret_kernel(monkeypatch, lanes):
    refine = lanes < 640  # the sampler's last round, at 640, draws nothing
    monkeypatch.setattr(tfr, "_cumsum_incl", lambda a: _block_prefix(a, True))
    monkeypatch.setattr(tfr, "_cumsum_excl", lambda a: _block_prefix(a, False))
    monkeypatch.setattr(tfr, "_row_sum", _block_row_sum)
    z, sdf, beta = _round_data(s=lanes, seed=lanes)
    beta0 = np.float32(2e-3 + 1e-4)
    bj, wj, pj = (np.asarray(a) for a in jfr.fused_sampler_round(
        jnp.asarray(z), jnp.asarray(sdf), jnp.asarray(beta), jnp.asarray(beta0),
        refine=refine, interpret=True, **ROUND,
    ))
    bt, wt, pt = (n(a) for a in tfr.fused_sampler_round(
        t(z), t(sdf), t(beta), torch.tensor(beta0), refine=refine, **ROUND
    ))
    flipped = np.abs(bt - bj) > K4_BETA_RTOL * np.abs(bj)
    assert flipped.sum() <= K4_MAX_FLIPPED * len(bj), flipped.sum()
    keep = ~flipped
    np.testing.assert_allclose(wt[keep], wj[keep], rtol=K4_RTOL, atol=K4_ATOL)
    np.testing.assert_allclose(pt[keep], pj[keep], rtol=K4_RTOL, atol=K4_ATOL)
    assert np.all(pt[:, -1] == 0.0) and (refine or np.all(pt == 0.0))
    # the emulated order is not cumsum's: on this row the two round apart
    x = t(wj[:1])
    assert not torch.equal(_block_prefix(x, True), torch.cumsum(x, dim=-1))


def test_round_sfu_count():
    """95 special-function operations a sample without refine, 100 with it,
    at 10 bisection steps; the last sample is no interval; a ray whose beta0
    check passes needs one evaluation of the bound, not 11."""
    assert tfr.sfu_ops(1, 128, 10, False) == 127 * 90 + 128 * 5
    assert tfr.sfu_ops(1024, 640, 10, True) == 1024 * (639 * 95 + 640 * 5)
    assert abs(tfr.sfu_ops(1024, 640, 10, False) / (1024 * 640) - 95) < 0.2
    assert tfr.sfu_ops(4, 128, 10, False, n_passed=1) == tfr.sfu_ops(4, 128, 10, False) - 10 * 8 * 127


def test_round_passed_check_is_the_bisections_beta0():
    z, sdf, beta = _round_data(s=128, seed=3)
    sdf[:20] = 5.0  # far from any surface: the check passes
    z, sdf, beta = t(z), t(sdf), t(beta)
    beta0 = torch.tensor(2e-3 + 1e-4)
    passed = tfr.passed_check(z, sdf, beta0, ROUND["eps"])
    assert bool(passed[:20].all()) and not bool(passed.all())
    got = tfr.fused_round_plain(z, sdf, beta, beta0, ROUND["eps"], 10, 0.0, False)[0]
    assert bool((got[passed] == beta0).all()) and bool((got[~passed] != beta0).all())


def test_round_wrapper_checks_its_inputs():
    z, sdf, beta = (t(a) for a in _round_data(r=4, s=128))
    beta0 = torch.tensor(2e-3)
    with pytest.raises(ValueError):  # the kernel itself refuses CPU tensors
        tfr.fused_round_kernel(z, sdf, beta, beta0.reshape(1), refine=True, **ROUND)
    with pytest.raises(ValueError):  # not a multiple of 128 samples
        tfr.fused_sampler_round(z[:, :100], sdf[:, :100], beta, beta0, refine=True, **ROUND)
    assert tfr.fused_round_kernel.launches == 0


def _sampler_inputs(rs, n_rays, scfg):
    d = rs.randn(n_rays, 3).astype(np.float32) * 0.2 + [0.0, 0.0, 1.0]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    cam = np.tile(np.asarray([[0.1, -0.05, -2.0]], np.float32), (n_rays, 1))
    total = scfg["n_samples_eval"] * scfg["max_total_iters"]
    final = scfg["n_samples"] + scfg["n_samples_extra"] + 2
    noise = {
        "strat": rs.rand(n_rays, scfg["n_samples_eval"]).astype(np.float32),
        "final_u": rs.rand(n_rays, scfg["n_samples"]).astype(np.float32),
        "z_extra_idx": rs.permutation(total)[: scfg["n_samples_extra"]].astype(np.int32),
        "eik_z_idx": rs.randint(0, final, (n_rays, 1)).astype(np.int32),
    }
    return d, cam, noise


def _sample_both(scfg_j, scfg_t, n_rays, seed=0):
    """z values of both samplers on the same rays and noise, sphere sdf."""
    common = {k: v for k, v in scfg_t.items() if k not in ("fused_rounds",)}
    d, cam, noise = _sampler_inputs(np.random.RandomState(seed), n_rays, common)
    run = jax.jit(
        lambda d, cam, noise: js.error_bound_z_vals(
            jax.random.PRNGKey(0), d, cam, lambda p: jnp.linalg.norm(p, axis=-1) - 0.8,
            LaplaceDensityParams(beta=jnp.asarray(0.1)), js.ErrorBoundSamplerConfig(**scfg_j),
            True, noise=noise,
        )
    )
    zj, ej = run(jnp.asarray(d), jnp.asarray(cam), {k: jnp.asarray(v) for k, v in noise.items()})
    zt, et = ts.error_bound_z_vals(
        t(d), t(cam), lambda p: torch.linalg.norm(p, dim=-1) - 0.8, LaplaceDensity(0.1),
        ts.ErrorBoundSamplerConfig(**scfg_t), True, noise={k: t(v) for k, v in noise.items()},
    )
    return np.asarray(zj), np.asarray(ej), n(zt), n(et)


def test_sampler_fused_rounds_matches_jax_interpret(monkeypatch):
    base = dict(n_samples=16, n_samples_eval=128, n_samples_extra=8, max_total_iters=3)
    calls = []
    plain = tfr.fused_round_plain
    monkeypatch.setattr(tfr, "fused_round_plain", lambda *a: calls.append(a[0].shape) or plain(*a))
    zj, ej, zt, et = _sample_both(
        dict(base, fused_rounds="interpret"), dict(base, fused_rounds="on"), n_rays=128
    )
    assert calls == [(128, 128), (128, 256), (128, 384)]  # every round went through the fused round
    # the same f32 steps on both sides, but the prefix sums add in another
    # order (log-step shifted adds against cumsum), and the inverse CDF divides
    # by small cdf steps: all but a few of the 3,328 z agree to 2e-5 (2 differ,
    # by at most 9.2e-4, when this was written), none by more than 2e-3
    diff = np.abs(zt - zj)
    assert np.mean(diff > 2e-5 + 2e-5 * np.abs(zj)) < 2e-3 and diff.max() < 2e-3, diff.max()
    np.testing.assert_allclose(et, ej, rtol=0, atol=2e-3)
    # 12 rays is no multiple of 128: the guard takes the unfused path, as the reference does
    calls.clear()
    small = dict(base, n_samples_eval=32)
    zj, _, zt, _ = _sample_both(dict(small), dict(small, fused_rounds="on"), n_rays=12)
    assert calls == []
    np.testing.assert_allclose(zt, zj, rtol=2e-5, atol=2e-5)


def test_sampler_grid_beta_search_matches_jax():
    scfg = dict(n_samples=16, n_samples_eval=32, n_samples_extra=8, max_total_iters=3,
                beta_search="grid", beta_grid_size=16)
    zj, ej, zt, et = _sample_both(scfg, scfg, n_rays=12)
    # the candidates beta0 * ratio ** t come from two pow implementations (an
    # ulp apart), and the inverse CDF divides by small cdf steps: 5e-4 on z,
    # the limit test_torch_sampling.py states for the same reason
    np.testing.assert_allclose(zt, zj, rtol=1e-4, atol=5e-4)
    np.testing.assert_allclose(et, ej, rtol=1e-4, atol=5e-4)
    zb = _sample_both(dict(scfg, beta_search="bisect"), dict(scfg, beta_search="bisect"), n_rays=12)[2]
    assert np.abs(zb - zt).max() > 1e-4  # the grid picks other betas than the bisection
    with pytest.raises(ValueError):
        ts.error_bound_z_vals(
            t(np.zeros((1, 3), np.float32)), t(np.zeros((1, 3), np.float32)), None,
            LaplaceDensity(0.1), ts.ErrorBoundSamplerConfig(beta_search="newton"), False,
        )


LR, DECAY, DECAY_STEPS = 5e-4, 0.1, 1000


def _one_step(flags_j, flags_t, n_rays, res, sampler=None):
    """(loss, parameters) after one step of both packages from the same
    weights, batch and noise."""
    spec = dict(NARROW, sampler=dict(NARROW["sampler"], **(sampler or {})))
    cfg_j, cfg_t = configs(spec, sampler_compute_dtype="float32")
    samp = lambda cfg, **kw: dataclasses.replace(cfg, sampler=dataclasses.replace(cfg.sampler, **kw))
    cfg_j = samp(dataclasses.replace(cfg_j, **flags_j.get("cfg", {})), **flags_j.get("sampler", {}))
    cfg_t = samp(dataclasses.replace(cfg_t, **flags_t.get("cfg", {})), **flags_t.get("sampler", {}))
    params = jneat.init_neat(jax.random.PRNGKey(3), cfg_j)
    model = port_model(params, cfg_t)
    scene = small_scene(cfg_j, res=res)
    state_j = jstep.init_train_state(params, LR, DECAY, DECAY_STEPS)
    step_j = jstep.make_train_step(cfg_j, jloss.LossConfig(), LR, DECAY, DECAY_STEPS, n_rays, res, donate=False)
    step_t = tstep.make_train_step(cfg_t, tloss.LossConfig(), LR, DECAY, DECAY_STEPS, n_rays, res)
    rng = jax.random.PRNGKey(11)
    r_batch, r_fwd = jax.random.split(jax.random.fold_in(rng, 0))
    inputs, gt = to_numpy(jstep.sample_batch(r_batch, scene, n_rays, res))
    noise = to_numpy(jneat.draw_forward_noise(r_fwd, n_rays, cfg_j))
    state_j, m_j = step_j(state_j, scene, rng)
    batch = ({k: t(v) for k, v in inputs.items()}, {k: t(v) for k, v in gt.items()})
    state_t, m_t = step_t(
        tstep.init_train_state(model), None, batch=batch, noise={k: t(v) for k, v in noise.items()}
    )
    return (float(m_j["loss"]), params_from_jax(to_numpy(state_j.params))), (
        float(m_t["loss"]), state_t.model.state_dict())


def _assert_step_close(jax_side, torch_side):
    (loss_j, p_j), (loss_t, p_t) = jax_side, torch_side
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-4)
    assert set(p_t) == set(p_j)
    bad = {k: float(np.abs(n(p_t[k]) - p_j[k].numpy()).max()) for k in p_j}
    bad = {k: v for k, v in bad.items() if v > 1e-5}
    assert not bad, f"parameters off after one step: {bad}"


def test_train_step_recompute_field_matches_jax():
    """JAX on its XLA field path (its Pallas field kernels take the canonical
    widths and a TPU); the port through the recompute autograd op, whose CPU
    version is field_math and its autograd."""
    kernel = dict(cfg=dict(use_pallas_sampler=True, use_pallas_field=True, pallas_field_backward="recompute"))
    _assert_step_close(*_one_step({}, kernel, n_rays=12, res=32))


def test_train_step_fused_rounds_matches_jax(monkeypatch):
    """128 rays and 128 proposals per round, so both samplers take the fused
    round: JAX through the Pallas interpreter, the port its plain round."""
    calls = []
    plain = tfr.fused_round_plain
    monkeypatch.setattr(tfr, "fused_round_plain", lambda *a: calls.append(a[0].shape) or plain(*a))
    _assert_step_close(*_one_step(
        dict(sampler=dict(fused_rounds="interpret")), dict(sampler=dict(fused_rounds="on")),
        n_rays=128, res=32, sampler=dict(n_samples_eval=128),
    ))
    assert len(calls) == NARROW["sampler"]["max_total_iters"]
