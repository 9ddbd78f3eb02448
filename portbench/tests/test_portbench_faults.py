"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a chip (``run.run_cell`` on the CPU,
at a small size) and plants one fault in the program under test, at the
entry the window drives (``optimize_pose_graph``): a solve that returns its
state unchanged, half of the batch left out (half of the graph's edges), an
answer altered where it is produced (one pose moved 1 cm). The exchange
between chips does not exist in a one-chip cell. A sound run, on the same
tree, is correct.
"""

import pytest
import torch

from portbench import harness, run

SEED = 2**40 + 11


def _cells():
    return [w["name"] for w in harness.benchmark()["workloads"]]


def _run(tree, cell):
    pkg, root = tree
    r = run.run_cell(cell, SEED, 0.5, False, "cpu", pkg=pkg, root=root, t_start=0.0)
    return r["correct"], r["failed"], r["checks"]


def _patch(monkeypatch, fault):
    import mloam_tpu_torch.parallel.sharded_pgo as G

    real = G.optimize_pose_graph

    def broken(poses, edges, *a, **kw):
        if fault == "unchanged":
            return poses
        if fault == "half_batch":
            w = edges.weight.clone()
            w[1::2] = 0.0
            edges = edges._replace(weight=w)
        out = real(poses, edges, *a, **kw)
        if fault == "altered":
            t = out.t.clone()
            t[-1] += 1e-2
            out = out._replace(t=t)
        return out

    monkeypatch.setattr(G, "optimize_pose_graph", broken)


@pytest.mark.parametrize("cell", _cells())
def test_sound_runs_are_correct(small_tree, cell):
    correct, failed, checks = _run(small_tree, cell)
    assert correct and failed == 0, checks


@pytest.mark.parametrize("cell", _cells())
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_broken_solve_is_not_correct(monkeypatch, small_tree, fault, cell):
    _patch(monkeypatch, fault)
    correct, failed, checks = _run(small_tree, cell)
    assert not correct and failed > 0, checks


def test_a_run_without_a_chip_exits_nonzero_and_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this process has a CUDA device")
    assert run.main(["--workload", _cells()[0], "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""
