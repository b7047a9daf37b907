"""The reference at tiny sizes on the CPU: against the program's plain
float32 path on the same weights and draws, and its parts against
independent computations."""

import numpy as np
import pytest
import torch

from conftest import tiny_root


@pytest.mark.parametrize("cell", ["tiny-abc.r32", "tiny-dtu.r32"])
def test_reference_follows_the_plain_f32_path(tmp_path, cell):
    """Three steps of the program's plain path in float32 (the CPU runs no
    kernel) and of the reference: the first step's loss terms to float32
    rounding, the three steps' after Adam within 2e-3, the first
    gradient's worst leaf within 1e-3 and the change's within 2e-2 (Adam's
    first steps move an element by about the learning rate whatever its
    gradient's size, so a near-zero gradient's rounding shows)."""
    from harness import cell as C
    from harness import check, manifest

    root = tiny_root(tmp_path, field_dtype="float32")
    c = manifest.load_cell(str(root), cell)
    dev = torch.device("cpu")
    run = C.prepare(str(root), c, 20241, dev)
    assert not run.model_cfg.use_pallas_field and run.model_cfg.field_compute_dtype == "float32"
    _, prog, records = C.first_steps(run, 20241, dev)
    assert len(records) == 3 and ("points" in records[0]) == c.config["model"]["dbscan_enabled"]
    assert check.junction_mismatches(records, c.config, dev) == 0
    ref = C.reference_steps(run, 20241, records)
    for k, v in ref[0][0].items():
        assert prog[0][0][k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    numbers = check.compare(*prog, *ref, run.weights)
    assert max(numbers[k] for k in ("loss",) + check.TERMS) < 2e-3, numbers
    assert numbers["grad"] < 1e-3 and numbers["change"] < 2e-2, numbers


def test_tangent_gradient_is_the_sdf_gradient():
    """The reference's forward-carried SDF gradient against autograd's, in
    float64, with the clamp and without."""
    import json
    import os

    from conftest import BENCH
    from harness import inputs
    from reference import neat_ref

    cfgfile = json.load(open(os.path.join(BENCH, "configs", "abc-neat-a.json")))
    rcfg = neat_ref.RefConfig.from_file(cfgfile)
    w = {k: v.double() for k, v in inputs.make_weights(cfgfile["model"], 3, "cpu").items()}
    x = (torch.rand((200, 3), dtype=torch.float64, generator=torch.Generator().manual_seed(0)) * 2 - 1) * 3.2
    for clamp in (True, False):
        xg = x.clone().requires_grad_(True)
        sdf, _, grad = neat_ref.implicit(w, xg, rcfg, "f32", tangent=True, clamp=clamp)
        (auto,) = torch.autograd.grad(sdf.sum(), xg)
        assert torch.allclose(grad, auto, rtol=1e-10, atol=1e-12)


def test_dbscan_is_the_eps_graph_components():
    """The reference's DBSCAN (min_samples 2) against scipy's connected
    components of the core points' eps graph."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components

    from reference import neat_ref

    g = torch.Generator().manual_seed(5)
    pts = torch.cat([torch.rand((300, 3), generator=g) * 0.05, torch.rand((200, 3), generator=g)])
    means, valid = neat_ref.cluster_means(pts, *neat_ref.dbscan_labels(pts, eps=0.01))
    p = pts.double().numpy()
    d = np.sqrt(((p[:, None] - p[None]) ** 2).sum(-1)) <= 0.01
    core = d.sum(1) >= 2
    sub = np.nonzero(core)[0]
    n, lab = connected_components(csr_matrix(d[np.ix_(sub, sub)]), directed=False)
    expect = {}
    for c in range(n):
        members = sub[lab == c]
        expect[int(members.min())] = p[members].mean(0)
    assert sorted(np.nonzero(valid.numpy())[0].tolist()) == sorted(expect)
    for i, m in expect.items():
        assert np.allclose(means[i].double().numpy(), m, atol=1e-6)
