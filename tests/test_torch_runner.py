"""The port's training CLI (neat_tpu_torch/train/runner.py) on the CPU,
with tests/test_runner.py's tiny conf (copied) on a synthetic scene.

The layout, the log, exact resume, the save on interrupt and SIGTERM, and
the flags that raise run on the port alone. The parity test trains two
epochs in both packages from the JAX runner's initial parameters (carried
across with ``params_from_jax``), each port step handed the JAX step's own
batch and noise (rebuilt from the JAX runner's keys, as
tests/test_torch_step.py does), and holds the parameters after each epoch
against the JAX runner's checkpoints.

Tolerance of the parity test: every entry of every parameter within
PARAM_ATOL = 1e-4 of JAX's after each epoch, 0.2 of one Adam step at the
initial learning rate (5e-4; the rate decays by 10x over the run's 8
steps). A parameter with a wrong or missing gradient moves by about a
step's size every step and ends some 2e-3 off. The two packages'
f32 gradients differ by summation order; Adam's update lr * g / |g| hides
that except where a gradient is near 0, and the proposals the sampler
evaluates in bf16 (the conf's default) differ by rounding between XLA and
PyTorch. The largest entry off after the second epoch is printed.
"""

import os
import os.path as osp
import re
import shutil
import signal

import jax
import numpy as np
import pytest
import torch

import neat_tpu.model.neat as jneat
import neat_tpu.train.checkpoint as jckpt
import neat_tpu.train.step as jstep
import neat_tpu_torch.train.runner as R
from neat_tpu.data.synthetic import generate_scene
from neat_tpu.train.runner import TrainRunner as JaxTrainRunner
from neat_tpu_torch.interop import params_from_jax
from neat_tpu_torch.train.checkpoint import host_state, load_checkpoint
from neat_tpu_torch.train.config import load_experiment_config
from _torch_helpers import one_thread


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


PARAM_ATOL = 1e-4

# tests/test_runner.py's TINY_CONF
TINY_CONF = """
train {
    expname = tiny
    dataset_class = datasets.blender_hawp_dataset.BlenderDataset
    model_class = model.networks.neat_wfr_rend_a.VolSDFNetwork
    loss_class = model.networks.loss_wfr.VolSDFLoss
    learning_rate = 5.0e-4
    num_pixels = 32
    checkpoint_freq = 1
    plot_freq = 100
    split_n_pixels = 256
}
plot {
    plot_nimgs = 1
    resolution = 32
    grid_boundary = [-1.5, 1.5]
}
loss {
    eikonal_weight = 0.1
    line_weight = 0.01
    rgb_loss = torch.nn.L1Loss
}
dataset {
    data_dir = toy
    img_res = [48, 48]
}
model {
    feature_vector_size = 16
    scene_bounding_sphere = 3.0
    dbscan_enabled = False
    use_median = True
    global_junctions {
        num_junctions = 8
        num_layers = 2
        dim_out = 3
        dim_hidden = 16
    }
    implicit_network {
        d_in = 3
        d_out = 1
        dims = [32, 32, 32, 32]
        geometric_init = True
        bias = 0.6
        skip_in = [2]
        weight_norm = True
        multires = 4
        sphere_scale = 20.0
    }
    attraction_network {
        d_in = 9
        d_out = 6
        dims = [16, 16]
        mode = idr
        weight_norm = True
    }
    rendering_network {
        mode = idr
        d_in = 9
        d_out = 3
        dims = [16, 16]
        weight_norm = True
        multires_view = 2
    }
    density {
        params_init { beta = 0.1 }
        beta_min = 0.0001
    }
    ray_sampler {
        near = 0.0
        N_samples = 8
        N_samples_eval = 16
        N_samples_extra = 4
        eps = 0.1
        beta_iters = 4
        max_total_iters = 2
    }
}
"""


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_runner_ws")
    os.makedirs(d / "toy")
    generate_scene(str(d / "toy"), n_views=4, res=(48, 48))
    (d / "tiny.conf").write_text(TINY_CONF)
    return d


def _runner(ws, exps, **kw):
    return R.TrainRunner(conf=str(ws / "tiny.conf"), data_root=str(ws), exps_folder=str(exps),
                         max_verts=16, device="cpu", **kw)


def _run(runner):
    try:
        runner.run()
    finally:
        runner.close()
    return runner


def _same_host_state(a, b):
    if a["step"] != b["step"]:
        return False
    return all(
        a[p].keys() == b[p].keys() and all(a[p][k].tobytes() == b[p][k].tobytes() for k in a[p])
        for p in ("params", "mu", "nu")
    )


def test_layout_and_log_lines(workspace, tmp_path):
    r = _run(_runner(workspace, tmp_path, nepochs=1))
    assert sorted(os.listdir(r.rundir)) == ["checkpoints", "junctions", "plots", "runconf.conf", "train.log"]
    assert os.listdir(r.plots_dir) == []
    assert sorted(os.listdir(r.ckpt_dir)) == ["0.ckpt", "1.ckpt", "ModelParameters", "latest.ckpt"]
    assert sorted(os.listdir(osp.join(r.ckpt_dir, "ModelParameters"))) == ["0.npz", "1.npz", "latest.npz"]
    for e in (0, 1):
        assert np.load(osp.join(r.junctions_dir, f"{e}.npy")).shape == (8, 3)
    log = open(osp.join(r.rundir, "train.log")).read()
    epochs = re.findall(r"tiny \[(\d+)/1\]: .*loss = [0-9.]+ .*\(([0-9,]+) rays/s\)", log)
    assert [e for e, _ in epochs] == ["0", "1"]
    assert "Training finished after 1 epochs" in log
    host, epoch = load_checkpoint(r.ckpt_dir)
    assert epoch == 1 and host["step"] == 2 * r.n_views == r.state.step
    # the snapshot resolves to the config it was written from
    again = load_experiment_config(osp.join(r.rundir, "runconf.conf"), max_verts=16, nepochs=1)
    assert again == load_experiment_config(str(workspace / "tiny.conf"), max_verts=16, nepochs=1)


def test_resume_loads_the_state_in_memory(workspace, tmp_path):
    first = _run(_runner(workspace, tmp_path, nepochs=1))
    resumed = _runner(workspace, tmp_path, nepochs=2, is_continue=True)
    assert resumed.rundir != first.rundir and resumed.start_epoch == 1
    assert _same_host_state(host_state(resumed.state), host_state(first.state))
    _run(resumed)
    host, epoch = load_checkpoint(resumed.ckpt_dir)
    # the exit save tags the last epoch run, so the resume runs epoch 1 again
    assert epoch == 2 and host["step"] == 4 * resumed.n_views
    # a resume that finds nothing to load starts from scratch
    fresh = _runner(workspace, tmp_path / "none", nepochs=1, is_continue=True)
    fresh.close()
    assert fresh.start_epoch == 0 and fresh.state.step == 0


@pytest.mark.parametrize("how", ["interrupt", "sigterm"])
def test_interrupt_saves_the_current_epoch(workspace, tmp_path, how):
    r = _runner(workspace, tmp_path, nepochs=10)
    handler = signal.getsignal(signal.SIGTERM)
    orig = r.dump_junctions
    armed = {"on": True}

    def bomb(epoch):
        if epoch == 3 and armed["on"]:
            armed["on"] = False
            if how == "interrupt":
                raise KeyboardInterrupt
            os.kill(os.getpid(), signal.SIGTERM)
        orig(epoch)

    r.dump_junctions = bomb
    with pytest.raises(KeyboardInterrupt if how == "interrupt" else SystemExit):
        _run(r)
    host, epoch = load_checkpoint(r.ckpt_dir)
    assert epoch == 3 and host["step"] == 3 * r.n_views
    assert signal.getsignal(signal.SIGTERM) is handler


def test_no_cuda_device_raises(workspace, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        R.main(["--conf", str(workspace / "tiny.conf"), "--data_root", str(workspace),
                "--exps_folder", str(tmp_path)])
    assert not os.path.exists(tmp_path / "tiny")


@pytest.mark.parametrize("flag,item", [
    (["--mesh"], "multi-GPU"),
    (["--distributed"], "multi-GPU"),
    (["--platform", "cpu"], "multi-GPU"),
    (["--use_tb"], "periphery"),
    (["--do_vis"], "periphery"),
    (["--gitexp"], "periphery"),
    (["--parallel_mode", "shard_map"], "multi-GPU"),
    (["--coordinator", "localhost:1234"], "multi-GPU"),
    (["--num_processes", "2"], "multi-GPU"),
    (["--process_id", "0"], "multi-GPU"),
])
def test_unported_flags_raise(workspace, tmp_path, flag, item):
    with pytest.raises(NotImplementedError, match=re.escape(f"ROADMAP.md §1, {item}")):
        R.main(["--conf", str(workspace / "tiny.conf"), "--data_root", str(workspace),
                "--exps_folder", str(tmp_path), "--device", "cpu", *flag])


@pytest.fixture(scope="module")
def two_views(workspace, tmp_path_factory):
    """The workspace's scene cut to its first two views (the loader drops
    the cameras of images it does not find), for the runs below."""
    d = tmp_path_factory.mktemp("torch_runner_two_views")
    shutil.copytree(workspace / "toy", d / "toy")
    for i in (2, 3):
        os.remove(d / "toy" / "images" / f"image_{i:04d}.png")
    (d / "tiny.conf").write_text(TINY_CONF)
    return d


def _main(ws, exps, *flags):
    return R.main(["--conf", str(ws / "tiny.conf"), "--data_root", str(ws),
                   "--exps_folder", str(exps), "--device", "cpu", "--nepoch", "1", *flags])


@pytest.fixture(scope="module")
def plain_run(two_views, tmp_path_factory):
    """Two epochs of the two-view scene through the CLI, no flags."""
    return _main(two_views, tmp_path_factory.mktemp("plain"))


def _log_metrics(runner):
    """The metric part of each epoch line of train.log."""
    log = open(osp.join(runner.rundir, "train.log")).read()
    return re.findall(r"\]: (.*) \([0-9,]+ rays/s\)", log)


def test_epoch_scan_equals_the_steps_one_by_one(two_views, plain_run, tmp_path):
    """--epoch_scan runs each epoch's steps in one multi-step call on the
    same generators: every checkpoint and every logged mean bit for bit."""
    scan = _main(two_views, tmp_path, "--epoch_scan", "--batch_size", "1")
    assert scan.epoch_scan and not plain_run.epoch_scan and scan.n_views == 2
    for tag in ("0", "1", "latest"):
        a, b = (load_checkpoint(r.ckpt_dir, tag) for r in (plain_run, scan))
        assert a[1] == b[1] and _same_host_state(a[0], b[0]), tag
    assert _log_metrics(plain_run) == _log_metrics(scan) and len(_log_metrics(scan)) == 2


def test_jax_command_line_flags_train(two_views, plain_run, tmp_path):
    """--batch_size (ignored, as in the JAX trainer) and --debug_nans (a
    finite check a step, which moves no bit) train; the NaN switch is off
    again after main."""
    from neat_tpu_torch.utils.profiling import nan_debugging_enabled

    flags = _main(two_views, tmp_path, "--batch_size", "4", "--debug_nans")
    assert not nan_debugging_enabled()
    assert _same_host_state(load_checkpoint(plain_run.ckpt_dir)[0], load_checkpoint(flags.ckpt_dir)[0])


def test_debug_nans_raises_on_a_nan_step(two_views, tmp_path):
    from neat_tpu_torch.train.step import step_generator
    from neat_tpu_torch.utils.profiling import enable_nan_debugging

    r = _runner(two_views, tmp_path, nepochs=1)
    try:
        def step():
            return r.step_fn(r.state, r.scene_dev, step_generator(0, 0, r.state.step, "cpu"))

        previous = enable_nan_debugging()
        try:
            r.state, aux = step()  # a clean step passes the check
            assert np.isfinite(float(aux["loss"]))
            with torch.no_grad():
                r.state.model.implicit.lin0.v[0, 0] = float("nan")
            before = host_state(r.state)
            with pytest.raises(FloatingPointError, match="step 1: the loss is not finite"):
                step()
            assert _same_host_state(before, host_state(r.state))  # nothing moved
        finally:
            enable_nan_debugging(previous)
        r.state, aux = step()  # the check off: the NaN goes through
        assert not np.isfinite(float(aux["loss"])) and r.state.step == 2
    finally:
        r.close()


def test_check_finite_names_the_first_tensor_at_fault():
    from neat_tpu_torch.utils.profiling import check_finite

    ok = torch.ones(3)
    check_finite(7, ["a", "b"], [ok, ok])
    with pytest.raises(FloatingPointError, match="step 7: b is not finite"):
        check_finite(7, ["a", "b", "c"], [ok, torch.tensor([1.0, float("inf")]), torch.tensor(float("nan"))])


def test_batch_rays_and_log_every_epochs(two_views, tmp_path):
    r = _run(_runner(two_views, tmp_path, nepochs=2, batch_rays=16, log_every_epochs=2))
    assert r.n_rays == 16
    log = open(osp.join(r.rundir, "train.log")).read()
    assert re.findall(r"tiny \[(\d+)/2\]", log) == ["0", "2"]
    assert load_checkpoint(r.ckpt_dir)[0]["step"] == 3 * r.n_views


def test_scene_to_device_gives_the_bench_scenes_keys(workspace):
    from neat_tpu_torch.data.datasets import load_scene_for_config
    from neat_tpu_torch.model.neat import NeatConfig
    from neat_tpu_torch.train.step import scene_to_device
    from neat_tpu_torch.utils.benchscene import bench_scene

    cfg = load_experiment_config(str(workspace / "tiny.conf"), max_verts=16)
    scene = load_scene_for_config(cfg, str(workspace))
    dev = scene_to_device(scene, "cpu")
    assert dev.keys() == bench_scene(NeatConfig.for_abc(), device="cpu").keys()
    for k, v in dev.items():
        assert v.numpy().tobytes() == getattr(scene, k).tobytes(), k


def test_step_generator_is_a_function_of_seed_epoch_and_step():
    from neat_tpu_torch.train.step import step_generator

    def draw(*args):
        return torch.rand(4, generator=step_generator(*args, device="cpu"))

    assert torch.equal(draw(42, 0, 5), draw(42, 0, 5))
    for other in ((43, 0, 5), (42, 1, 5), (42, 0, 6)):
        assert not torch.equal(draw(42, 0, 5), draw(*other))


# ---------------------------------------------------------------------------
# parity with the JAX runner
# ---------------------------------------------------------------------------


def _jax_draws(runner, n_epochs):
    """Each step's (inputs, ground truth, noise) as the JAX runner draws
    them: split(PRNGKey(seed)) per epoch, then fold_in(key, state.step)."""
    rng = jax.random.PRNGKey(runner.seed)
    out, step = [], 0
    for _ in range(n_epochs):
        rng, sub = jax.random.split(rng)
        keys = jax.random.split(sub, runner.n_views)
        for i in range(runner.n_views):
            r_batch, r_fwd = jax.random.split(jax.random.fold_in(keys[i], step))
            inputs, gt = jstep.sample_batch(r_batch, runner.scene_dev, runner.n_rays, runner.scene.img_res[1])
            noise = jneat.draw_forward_noise(r_fwd, runner.n_rays, runner.cfg.model)
            out.append(tuple({k: torch.as_tensor(np.array(v)) for k, v in d.items()} for d in (inputs, gt, noise)))
            step += 1
    return out


def _worst(port_params, jax_params):
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))
    assert set(ref) == set(port_params)
    return {k: float(np.abs(port_params[k] - ref[k].numpy()).max()) for k in ref}


def test_two_epochs_match_the_jax_runner(workspace, tmp_path, capsys):
    jr = JaxTrainRunner(conf=str(workspace / "tiny.conf"), data_root=str(workspace),
                        exps_folder=str(tmp_path / "jax"), nepochs=1, max_verts=16)
    p0 = jax.tree_util.tree_map(np.array, jr.state.params)
    draws = _jax_draws(jr, 2)
    jr.run()

    tr = _runner(workspace, tmp_path / "torch", nepochs=1)
    assert tr.n_views == jr.n_views and tr.n_rays == jr.n_rays
    assert not (tr.cfg.model.use_pallas_sampler or tr.cfg.model.use_pallas_field)
    tr.state.model.load_state_dict(params_from_jax(p0), strict=True)
    queue = iter(draws)
    step = tr.step_fn

    def injected(state, scene, gen):
        inputs, gt, noise = next(queue)
        return step(state, None, batch=(inputs, gt), noise=noise)

    tr.step_fn = injected
    _run(tr)
    assert next(queue, None) is None

    for epoch in (1, "latest"):  # after epoch 0 (saved as epoch 1 starts) and after epoch 1
        jstate, jepoch = jckpt.load_checkpoint(osp.join(jr.rundir, "checkpoints"), str(epoch))
        tstate, tepoch = load_checkpoint(tr.ckpt_dir, str(epoch))
        assert tepoch == jepoch and tstate["step"] == int(jstate.step)
        worst = _worst(tstate["params"], jstate.params)
        with capsys.disabled():
            print(f"\nafter epoch {jepoch - (epoch == 1)}: largest |port - JAX| entry "
                  f"{max(worst.values()):.3g} ({max(worst, key=worst.get)})")
        bad = {k: v for k, v in worst.items() if v > PARAM_ATOL}
        assert not bad, f"parameters off after checkpoint {epoch}: {bad}"
