"""What the port does not run yet raises, and names its ROADMAP item.

Each message names the item by its title ("ROADMAP.md §1, data"), not
by a number that a renumbering of the queue would leave pointing elsewhere.
"""

import dataclasses

import pytest
import torch

import neat_tpu_torch.assignment.matching as tm
import neat_tpu_torch.model.neat as tneat


def _scannet_scene():
    from neat_tpu_torch.data.datasets import load_scene

    load_scene("scannet", data_dir="x", img_res=(8, 8))


def _variant():
    tneat.check_ported(dataclasses.replace(tneat.NeatConfig.for_abc(), dual_batch=True))


def _callback_assignment():
    tm.masked_assignment(torch.zeros((3, 4)), method="callback")


def _finalize_mesh():
    from neat_tpu_torch.wireframe.finalize import main

    main(["--conf", "run/runconf.conf", "--mesh", "4"])


def _render_eval_mesh():
    from neat_tpu_torch.evaluation.render_eval import main

    main(["--conf", "run/runconf.conf", "--mesh", "4"])


@pytest.mark.parametrize(
    "call,item",
    [
        (_scannet_scene, "ROADMAP.md §1, data"),
        (_variant, "ROADMAP.md §1, variants"),
        (_callback_assignment, "ROADMAP.md §1, assignment `callback` mode"),
        (_finalize_mesh, "ROADMAP.md §1, multi-GPU"),
        (_render_eval_mesh, "ROADMAP.md §1, multi-GPU"),
    ],
    ids=["scannet_scene", "variant", "callback_assignment", "finalize_mesh", "render_eval_mesh"],
)
def test_unported_paths_raise_and_name_their_item(call, item):
    with pytest.raises(NotImplementedError) as err:
        call()
    assert item in str(err.value)
    assert "item " not in str(err.value)  # no item number
