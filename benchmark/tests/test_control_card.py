"""The control on the card, at the cells' own size: the reference in the
precision below the configuration's (fp8 products in the field pass and
the sampler, TF32 elsewhere) put in the program's place fails one of the
cell's limits or more, while the program itself holds them all, on two
seeds. Skips without a card.

    python -m pytest benchmark/tests/test_control_card.py -q
"""

import pytest
import torch

from conftest import ROOT

CELLS = ["abc-neat-a.r8192", "dtu.r8192", "dtu.r1024"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run the hand-written kernels")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_the_program_holds(card, name):
    from harness import cell as C
    from harness import check, manifest
    from reference import neat_ref

    c = manifest.load_cell(ROOT, name)
    step = None
    for seed in (7001, 7002):
        run = C.prepare(ROOT, c, seed, card, step)
        step = run.step
        _, prog, records = C.first_steps(run, seed, card)
        sound = check.judge(C.checked_numbers(run, seed, prog, records), c.limits)
        assert check.holds(sound), sound
        ctl_records, ctl_stages = [], {}
        losses, g1, p3 = C.reference_steps(run, seed, prec=neat_ref.CONTROL, record=ctl_records, stages=ctl_stages)
        ctl_records[0].update(k1=ctl_stages["k1"], field=ctl_stages["field"])
        moment1 = {k: g * (1.0 - check.B1) for k, g in g1.items()}
        control = check.judge(C.checked_numbers(run, seed, (losses, moment1, p3), ctl_records), c.limits)
        assert not check.holds(control), control
        del run
        torch.cuda.empty_cache()
