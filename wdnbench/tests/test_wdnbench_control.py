"""The control on the card: the reference put in the program's place and
computed with TF32 GEMMs, the precision below the configurations' float32,
must come out not correct by the committed limits. Each cell at its own
sizes, on one seed (``prove.py --control-seeds`` reads more)."""

import pytest

from wdnbench import check, harness, prove
from wdnbench.tests import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [tiny.SERVE, tiny.TRAIN])
def test_the_control_fails_the_limits(card, cell):
    c = harness.Cell(cell)
    numbers = prove.control(c, 2**31 + 99, card)
    correct, checks = check.judge(numbers, c.limits)
    assert not correct, checks
