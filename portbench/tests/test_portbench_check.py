"""``correct`` comes out false for the control and for each fault a cell
can have, and true for the program as it is: a whole run on the CPU at a
small size, the harness's look for a card skipped."""

import time

import pytest

from portbench import compare, faults, harness, inputs
from portbench.tests.conftest import CELLS

SMALL = {"size": 64, "batch": 2, "pool": 2}


def run(root, cell, plant=None):
    return harness.run_cell(root, cell, 2**31 + 99, 2.0, False, "cpu", time.perf_counter(),
                            overrides=SMALL, plant=plant)


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_is_correct(root, cell):
    r = run(root, cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 2
    assert r["checks"]["det_gap"]["value"] < 1e-5


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_each_fault_is_caught(root, cell, fault):
    r = run(root, cell, faults.FAULTS[fault])
    assert not r["correct"]
    assert r["checks"]["det_gap"]["value"] > r["checks"]["det_gap"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(root, cell):
    """The cell's reference with int4 weights (W4A8) in the program's place."""
    c, config = harness.cell_files(root, cell)
    ref = harness.reference(config)
    net = ref.parse(harness.cfg_text(config, SMALL["size"]))
    for seed in (1, 2, 3):
        weights = inputs.float_params(net, seed, "cpu")
        ranges = harness.range_rule(config)(net)
        pool = inputs.frame_pool(SMALL["pool"], SMALL["batch"], SMALL["size"], seed, "cpu")
        control = ref.convert(net, weights, ranges, "cpu", bits=4)
        items = [(p, ref.answers(control, pool[p], config["max_det"])) for p in range(len(pool))]
        found = harness.judge(ref, net, weights, ranges, pool, "cpu", config["max_det"], items)
        assert found["det_gap"] > c["checks"]["det_gap"] * 100


def test_a_malformed_answer_fails():
    assert compare.judge([(0, None)], lambda p: [], 2, 10)["det_gap"] == float("inf")
