"""The check against a broken timed path: a whole run on the CPU (the
look for a card skipped) with a fault planted underneath the step, at a
tiny size in float32, where a sound run holds limits far tighter than the
faults read; each fault makes ``correct`` false. The exchange between
chips has no fault here: every cell runs on one chip."""

import pytest

from conftest import tiny_root

LIMITS = {"loss": 2e-3, "grad": 2e-3, "change": 3e-2, "proposals": 1e-4}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("faults"), field_dtype="float32", limits=LIMITS)


def _run(root, cell="tiny-abc.r32"):
    from harness.cell import run_cell

    return run_cell(str(root), cell, 2**31 + 77, 0.3, False, device="cpu", require_card=False)


@pytest.mark.parametrize("cell", ["tiny-abc.r32", "tiny-dtu.r32"])
def test_a_sound_run_is_correct(root, cell):
    res = _run(root, cell)
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered", "gathered"])
def test_a_fault_is_not_correct(root, fault):
    from harness import faults

    with faults.FAULTS[fault]():
        res = _run(root)
    assert res["correct"] is False, res["checks"]
    if fault == "gathered":  # read by the stage check itself
        assert res["checks"]["proposals"]["value"] > LIMITS["proposals"], res["checks"]


@pytest.mark.parametrize("fault", [False, True])
def test_the_proposal_check_reads_wrong_means(fault):
    """The tiny dtu cell's endpoints form no cluster, so the fault in
    DBSCAN's means is read here on clustered points: the program's means,
    sound and rounded, against the reference's of the same points, as
    ``check.proposal_gap`` compares them."""
    import contextlib

    import torch

    import neat_tpu_torch.model.neat as N
    from harness import check, faults
    from reference import neat_ref

    gen = torch.Generator().manual_seed(5)
    centres = torch.rand((40, 3), generator=gen) * 2.0 - 1.0
    points = centres.repeat_interleave(4, 0) + 0.002 * torch.rand((160, 3), generator=gen)
    points = points[torch.randperm(160, generator=gen)]
    with faults.FAULTS["means"]() if fault else contextlib.nullcontext():
        means, valid = N.dbscan_cluster_means(points, eps=0.01, min_samples=2)
    ref, ref_valid = neat_ref.cluster_means(points, *neat_ref.dbscan_labels(points))
    assert torch.equal(valid, ref_valid) and int(valid.sum()) == 40
    gap = check._max_gap(means[valid], ref[valid])
    assert (gap > LIMITS["proposals"]) if fault else (gap < 1e-6), gap
