"""What the port does not run yet raises, and names its ROADMAP item.

Each message names the item by its title ("ROADMAP.md §1, DTU path"), not
by a number that a renumbering of the queue would leave pointing elsewhere.
"""

import dataclasses

import pytest
import torch

import neat_tpu_torch.assignment.matching as tm
import neat_tpu_torch.model.loss as tloss
import neat_tpu_torch.model.neat as tneat


def _depth_loss():
    tloss.neat_loss({}, {}, tloss.LossConfig(depth_weight=1.0))


def _variant():
    tneat.check_ported(dataclasses.replace(tneat.NeatConfig.for_abc(), dual_batch=True))


def _callback_assignment():
    tm.masked_assignment(torch.zeros((3, 4)), method="callback")


@pytest.mark.parametrize(
    "call,item",
    [
        (_depth_loss, "ROADMAP.md §1, DTU path"),
        (_variant, "ROADMAP.md §1, variants"),
        (_callback_assignment, "ROADMAP.md §1, assignment `callback` mode"),
    ],
    ids=["depth_loss", "variant", "callback_assignment"],
)
def test_unported_paths_raise_and_name_their_item(call, item):
    with pytest.raises(NotImplementedError) as err:
        call()
    assert item in str(err.value)
    assert "item " not in str(err.value)  # no item number
