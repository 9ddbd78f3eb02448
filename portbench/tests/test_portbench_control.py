"""The control fails the cell's limits: the reference in the precision below
the configuration's (float32 with TF32 matrix products, for float32 with
TF32 off), in the program's place, on the card at the cell's own size, over
the first solves of a drive, on one seed. The readings the limits are set
from (a dozen seeds for the program, three or more for the control) come
from ``python3 -m portbench.control`` and are in ``PERF.md``."""

import pytest
import torch

from portbench import control, harness


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in harness.benchmark()["workloads"]])
def test_control_fails_a_limit(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the control is TF32, which the CPU lacks)")
    conf, traffic, limits = harness.cell_files(harness.cell_spec(harness.benchmark(), cell))
    P = harness.kind_module(traffic)
    dev = torch.device("cuda:0")
    gaps = control.control_gaps(P, traffic, limits, P.Inputs(conf, 7, dev), 3, dev)
    assert any(gaps[k] > limits[k] for k in limits), gaps
