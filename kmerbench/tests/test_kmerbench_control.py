"""Each cell's control (its configuration's narrower key or count, the
reference in the program's place) comes out not correct at a size a test
run holds.  The sizes are the smallest at which the narrower width can
show: some 10^5 distinct 21-mers for a 32-bit key to collide, an 8-mer
seen over 32767 times for an int16 count to saturate."""

import pytest

from kmerbench import control, gen, harness

SIZES = {
    "k21c.chr1": {},
    "k21c.reads_histo": {"genome": 150_000, "coverage": 10},
    "k21c.isolates": {"samples": 2, "ancestor": 700_000,
                      "size": [500_000, 600_000], "block": 10_000},
    "k8.chr1": {"microsat": {"share": 0.2, "motifs": ["A"], "run": [20, 120],
                             "div": 0.02}},
}


@pytest.mark.parametrize("cell_name", sorted(SIZES))
def test_the_control_is_not_correct(cell_name):
    cell = harness.load_cell(cell_name)
    params = gen.load(cell.traffic["generator"]).tiny(cell.traffic["params"])
    r = control.readings(cell, 2**31 + 3, "cpu",
                         {**params, **SIZES[cell_name]})
    assert not r["correct"], r
    assert r["compared"]["blocks_differing"] > 0
