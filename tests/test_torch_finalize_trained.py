"""The finalize CLI of the port (neat_tpu_torch/wireframe/finalize.py)
against neat_tpu.wireframe.finalize on trained weights, at the reference
gates: the default ``--recipe reference``, ``--vote-ratio 0.2``, the 0.01
line-score gate, ``--reproj-dis 10``, ``--junc_match_threshold 0.02``,
``--ckdist 100``, ``--ckview 5``.

The weights are tests/data/finalize_trained/params.npz: the narrow model
of that directory's runconf.conf, trained by the JAX package's training
CLI on the generated cuboid this test generates again from its seed
(make_fixture.py there says how). Each package writes its own checkpoint
of them into one rundir and runs its own ``finalize.main`` there, in f32,
the way tests/test_torch_finalize.py::test_wireframe_recon_cli_matches_jax
does; the same checks: the same file names, equal ``votes_idx``,
``graph_initial`` and ``junction_votes``, every other array within that
test's F32_TOL of its largest entry (``scores_raw`` within SCORE_TOL).
``votes_pts`` are endpoints of the distillation's ``lines3d_raw`` (those
that voted), so they are held at that array's scale: on these weights one
line's mean over its rays moves by 1.2e-4 between the packages in f32, in
both arrays, which is within F32_TOL of ``lines3d_raw``'s largest entry
(1.99) but not of the voting endpoints' (0.41). Here the wireframe is not
empty: both packages keep junctions and visibility-checked lines, and
eval_abc gives both the same numbers.
"""

import os
import os.path as osp
import shutil

import jax
import numpy as np
import pytest

import neat_tpu.model.neat as jneat
import neat_tpu.wireframe.finalize as jfin
import neat_tpu_torch.wireframe.finalize as tfin
from _torch_helpers import jax_numpy_encodels, one_thread, port_model
from test_torch_finalize import F32_TOL, SCORE_TOL, _close, _numpy_only, _outputs

FIXTURE = osp.join(osp.dirname(osp.abspath(__file__)), "data", "finalize_trained")
SCENE = dict(n_views=12, res=(256, 256), seed=0)  # make_fixture.py's scene
DATA_DIR = osp.join("abc", "00075213")
EPOCH = 3  # the epoch both checkpoints are saved under
# the reference gates are the CLI's defaults; 512-ray chunks pad a view's
# 1,100-1,500 support rays less than the default 2,048
CLI = ["--vote-ratio", "0.2", "--chunksize", "512"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


def fixture_params(cfg_j):
    """The JAX parameter tree of params.npz: init_neat's tree with every
    leaf replaced by the array under its key string."""
    tree = jneat.init_neat(jax.random.PRNGKey(0), cfg_j)
    with np.load(osp.join(FIXTURE, "params.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    assert sorted(arrays) == sorted(jax.tree_util.keystr(k) for k, _ in leaves)
    return jax.tree_util.tree_unflatten(treedef, [arrays[jax.tree_util.keystr(k)] for k, _ in leaves])


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    from neat_tpu_torch.data.synthetic import generate_scene

    root = str(tmp_path_factory.mktemp("finalize_trained"))
    generate_scene(osp.join(root, DATA_DIR), **SCENE)
    return root


@pytest.fixture(scope="module")
def finalized(scene_root, tmp_path_factory):
    """Both packages' finalize on one rundir: (rundir, JAX's outputs, the
    port's outputs), each {file name: its arrays / the pickle}."""
    import neat_tpu.train.checkpoint as jckpt
    import neat_tpu.train.step as jstep
    from neat_tpu.train.config import load_experiment_config as jload
    from neat_tpu_torch.train.checkpoint import save_checkpoint
    from neat_tpu_torch.train.config import load_experiment_config as tload
    from neat_tpu_torch.train.step import init_train_state

    rundir = str(tmp_path_factory.mktemp("exps") / "fin" / "2026_01_01_00_00_00")
    ckpt = osp.join(rundir, "checkpoints")
    os.makedirs(ckpt)
    conf = osp.join(rundir, "runconf.conf")
    shutil.copy(osp.join(FIXTURE, "runconf.conf"), conf)
    cfg_j, cfg_t = jload(conf).model, tload(conf).model
    params = fixture_params(cfg_j)
    base = CLI + ["--conf", conf, "--data_root", scene_root]

    jckpt.save_checkpoint(ckpt, jstep.init_train_state(params, 5e-4, 0.1, 100), EPOCH)
    with jax_numpy_encodels():
        jfin.main(base)
    want = _outputs(rundir)

    for name in os.listdir(ckpt):
        if name.endswith(".ckpt"):
            os.remove(osp.join(ckpt, name))
    os.rename(osp.join(rundir, "wireframes"), osp.join(rundir, "wireframes_jax"))
    save_checkpoint(ckpt, init_train_state(port_model(params, cfg_t)), EPOCH)
    tfin.main(base + ["--device", "cpu"])
    return rundir, want, _outputs(rundir)


def _wireframe(outputs) -> dict:
    (name,) = [n for n in outputs if n.endswith("-neat.pkl")]
    return outputs[name]


def test_trained_wireframe_is_not_empty(finalized):
    _, want, got = finalized
    for res in (_wireframe(want), _wireframe(got)):
        assert res["junctions3d_initial"].shape[0] > 0
        assert res["lines3d_wfi_checked"].shape[0] > 0
        assert res["kwargs"]["vote_threshold"] == 2  # round(0.2 x 12 views)


def test_finalize_cli_matches_jax_on_trained_weights(finalized):
    _, want, got = finalized
    assert sorted(got) == sorted(want)
    assert [name.endswith("-distill.pkl") for name in sorted(got)].count(True) == 1
    for name in want:
        a, b = got[name], want[name]
        if name.endswith(".pkl"):
            assert _numpy_only(a) and _numpy_only(b), name
        assert set(a) == set(b), name
        for k in b:
            if k == "kwargs":
                assert a[k] == b[k]
            elif k in ("votes_idx", "graph_initial", "junction_votes"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}:{k}")
            else:
                tol = SCORE_TOL if k == "scores_raw" else F32_TOL
                scale = b["lines3d_raw"] if k == "votes_pts" else b[k]
                _close(a[k], b[k], tol * max(1.0, float(np.abs(scale).max(initial=0.0))), f"{name}:{k}")


def test_eval_abc_matches_jax_on_trained_weights(finalized, scene_root):
    from neat_tpu.evaluation.eval_abc import eval_abc as jeval_abc
    from neat_tpu_torch.evaluation.eval_abc import eval_abc as teval_abc

    rundir, want, _ = finalized
    scan = osp.join(scene_root, DATA_DIR)
    (name,) = [n for n in want if n.endswith("-neat.pkl")]
    pj, pt = osp.join(rundir, "wireframes_jax", name), osp.join(rundir, "wireframes", name)
    got = teval_abc(pt, scan, verbose=False)
    assert got == jeval_abc(pj, scan, verbose=False)
    assert got == teval_abc(pj, scan, verbose=False)
    assert max(got["junction_recall"]) > 0 and max(got["line_recall"]) > 0
