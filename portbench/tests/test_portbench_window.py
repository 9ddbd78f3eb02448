"""The window arithmetic (ms a Gauss-Newton step over completed solves), the
pose gaps and the limits' comparison."""

import math

import pytest
import torch

from portbench import harness
from portbench.kinds import pgo_loops
from portbench.ref import pgo as ref


def test_ms_per_step_counts_steps_of_completed_solves():
    # 14 solves of 10 steps in 30.8 s: 220 ms a step
    assert harness.ms_per_unit(14 * 10, 30.8) == pytest.approx(220.0)
    assert harness.ms_per_unit(0, 1.0) is None


def test_pose_gaps_translation_and_angle():
    half = 0.05
    Ra = ref.quat_to_matrix(torch.tensor([[1.0, 0, 0, 0]], dtype=torch.float64))
    q = torch.tensor([[math.cos(half), 0, 0, math.sin(half)]], dtype=torch.float64)
    Rb = ref.quat_to_matrix(q)
    dt, dr = ref.pose_gaps(Ra, torch.zeros(1, 3), Rb, torch.tensor([[0.3, 0.4, 0.0]]))
    assert dt.item() == pytest.approx(0.5)
    assert dr.item() == pytest.approx(2 * half)
    # q and -q are one rotation
    dt, dr = ref.pose_gaps(Rb, torch.zeros(1, 3), ref.quat_to_matrix(-q), torch.zeros(1, 3))
    assert dt.item() == 0.0 and dr.item() == pytest.approx(0.0, abs=1e-12)


def test_the_compared_solves_are_the_first_and_a_draw_from_the_seed():
    a = pgo_loops.checked(1, 15, 2, 2**40 + 3)
    assert a[0] == 0 and len(a) == 3 and all(1 <= k < 15 for k in a[1:])
    assert a == pgo_loops.checked(1, 15, 2, 2**40 + 3)
    # a window of one solve compares it
    assert pgo_loops.checked(1, 2, 2, 5) == [0, 1]


def test_a_nan_never_passes():
    checks = {}
    harness.check(checks, "pose_t_m", float("nan"), {"pose_t_m": 1.0})
    assert not harness.passed(checks)
    harness.check(checks, "pose_t_m", 0.5, {"pose_t_m": 1.0})
    assert harness.passed(checks)
