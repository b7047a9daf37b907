"""The ABC wireframe evaluation of the port
(neat_tpu_torch/evaluation/eval_abc.py) against neat_tpu.evaluation.eval_abc:
the same pickle and lines.json give exactly the same numbers (tolerance 0:
both are the same numpy and scipy calls), with offset_scale.txt and without
it (the transform then comes from the GT bounding box)."""

import importlib
import json
import os
import os.path as osp
import pickle

import numpy as np
import pytest

import neat_tpu_torch.evaluation.eval_abc as tabc

# the package's __init__ binds the name eval_abc to the function
jabc = importlib.import_module("neat_tpu.evaluation.eval_abc")


@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    from neat_tpu_torch.data.synthetic import generate_scene

    root = str(tmp_path_factory.mktemp("abc"))
    generate_scene(osp.join(root, "toy"), n_views=2, res=(32, 32), seed=0)
    return osp.join(root, "toy")


def _prediction(scan, seed, noise):
    """A -neat.pkl-like result: the GT wireframe perturbed, a few GT
    junctions dropped and a few spurious ones and lines added."""
    with open(osp.join(scan, "lines.json")) as f:
        gt = json.load(f)
    rs = np.random.RandomState(seed)
    j = np.asarray(gt["junctions"], np.float32)
    lines = j[np.asarray(gt["lines"])]
    jp = np.concatenate([j[2:], rs.rand(3, 3).astype(np.float32)]) + rs.normal(0, noise, (len(j) + 1, 3))
    lp = np.concatenate([lines[1:], rs.rand(2, 2, 3).astype(np.float32)])
    lp = lp + rs.normal(0, noise, lp.shape)
    return {"junctions3d_initial": jp.astype(np.float32), "lines3d_wfi_checked": lp.astype(np.float32)}


@pytest.mark.parametrize("offset_scale", ["0 0 0 1\n", "0.1 -0.2 0.3 2.5\n", None], ids=["identity", "scaled", "bbox"])
@pytest.mark.parametrize("noise", [0.0, 0.01, 0.05])
def test_eval_abc_numbers_equal_jax(scan, tmp_path, offset_scale, noise):
    scan_dir = str(tmp_path / "scan")
    os.makedirs(scan_dir)
    with open(osp.join(scan, "lines.json")) as f:
        text = f.read()
    with open(osp.join(scan_dir, "lines.json"), "w") as f:
        f.write(text)
    if offset_scale is not None:
        with open(osp.join(scan_dir, "offset_scale.txt"), "w") as f:
            f.write(offset_scale)
    np.testing.assert_array_equal(tabc.load_scale_mat(scan_dir), jabc.load_scale_mat(scan_dir))
    pkl = str(tmp_path / "pred-neat.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(_prediction(scan, 3, noise), f)
    want = jabc.eval_abc(pkl, scan_dir, verbose=False)
    assert tabc.eval_abc(pkl, scan_dir, verbose=False) == want
    with open(pkl, "rb") as f:
        assert tabc.eval_abc(pickle.load(f), scan_dir, verbose=False) == want
    assert tabc.main(["--data", pkl, "--scan", scan_dir]) == want


def test_eval_abc_scores_the_gt_wireframe_perfectly(scan, tmp_path):
    with open(osp.join(scan, "lines.json")) as f:
        gt = json.load(f)
    j = np.asarray(gt["junctions"])
    out = tabc.eval_abc({"junctions3d_initial": j, "lines3d_wfi_checked": j[np.asarray(gt["lines"])]}, scan,
                        verbose=False)
    for k in ("junction_precision", "junction_recall", "line_precision", "line_recall"):
        assert out[k] == [1.0, 1.0, 1.0], k
