"""Whole runs of both cells on the CPU at a small size, past the harness's
look for a card: a sound run comes out correct, and each fault planted under
the timed path (``prove.plant``) comes out not correct."""

import pytest

from wdnbench import prove
from wdnbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_checkout(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", [tiny.SERVE, tiny.TRAIN])
@pytest.mark.parametrize("traced", [False, True])
def test_a_sound_run_is_correct(root, cell, traced):
    from gnn_pressure_estimation_tpu_torch.ops import _build

    load = _build.load
    result, numbers = tiny.run(root, cell, traced=traced)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["failed"] == 0 and result["attempted"] > 0
    # the window's end is held in training; set-up's timing of the loads is undone
    assert ("wgrad_gap" in result["checks"]) == (cell == tiny.TRAIN)
    assert _build.load is load


@pytest.mark.parametrize("cell, fault", [(tiny.TRAIN, "unchanged"), (tiny.TRAIN, "half"),
                                         (tiny.SERVE, "half"), (tiny.SERVE, "altered")])
def test_a_planted_fault_is_caught(root, cell, fault):
    remove = prove.plant(fault)
    try:
        result, _ = tiny.run(root, cell)
    finally:
        remove()
    assert not result["correct"], result["checks"]
