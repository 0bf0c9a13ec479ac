"""The control: the reference computed one precision below the
configuration's, put in the program's place, fails a number of each cell,
while the program passes them all (on the CPU, at a size where a group's
int32 sum passes int16's range, as it does at the cells' own size)."""

import pytest
import torch

from portbench import control, harness
from portbench.tests.conftest import write_small

SIZES = {
    "h2o-groupby-1e8-k100": {"N": 200000, "K": 10},
    "h2o-join-1e8": {"rows": {"x": 20000, "small": 10, "medium": 1000, "big": 20000},
                     "key_n": {"id1": 10, "id2": 1000, "id3": 20000}},
}


@pytest.mark.parametrize("cell", [
    "h2o-groupby-1e8-k100.q1-q2", "h2o-groupby-1e8-k100.q3-q4-q5",
    "h2o-join-1e8.q5-big", "h2o-join-1e8.q1-q2-small-medium",
])
def test_control_fails_program_passes(tmp_path, cell):
    cat = harness.Catalog(bases=[write_small(tmp_path, SIZES), harness.HERE])
    limits = cat.json("configs", cat.json("cells", cell)["config"])["limits"]
    readings = control.readings(cat, cell, [5, 6], torch.device("cpu"))
    program = [n for _s, _q, side, n in readings if side == "program"]
    lower = [n for _s, _q, side, n in readings if side == "control"]
    assert program and all(v <= limits[k] for n in program for k, v in n.items())
    for seed in (5, 6):  # on each seed, some question's control fails some number
        assert any(v > limits[k] for s, _q, side, n in readings if s == seed and side == "control"
                   for k, v in n.items())
    assert len(lower) == len(program)
