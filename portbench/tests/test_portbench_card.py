"""On the card: each cell runs, short, with its trace, and is correct.

    python -m pytest portbench/tests -m cuda
"""

import time

import pytest

from portbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny416-b128-closed", "v3-416-b64-offline"])
def test_cell_on_the_card(root, cuda_device, cell):
    r = harness.run_cell(root, cell, 2**31 + 7, 2.0, True, cuda_device, time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0 and r["device"]["window_s"] > 0
    assert 0 < r["metrics"][f"mfu_int8.{cell.rsplit('-', 1)[1]}"]["value"] < 100
