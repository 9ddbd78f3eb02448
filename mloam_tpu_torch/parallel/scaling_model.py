"""The pose graph of the distributed solvers' scaling runs.

Counterpart of ``make_survey_graph`` in ``mloam_tpu/parallel/scaling_model.py``.
The rest of that module reads XLA's compiled HLO and cost analysis and
applies TPU fabric constants; the port has no counterpart of it: its meshes
count their collectives themselves (``parallel/mesh.py``), and its times are
measured on the card.
"""

from __future__ import annotations

import math

import torch

from mloam_tpu_torch import resolve_device
from mloam_tpu_torch.core import se3
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.parallel.sharded_pgo import PoseGraphEdges


def make_survey_graph(n: int, n_loops: int = 32, noise: float = 0.05,
                      seed: int = 0, device=None):
    """Reference-shaped pose graph: a survey ring (0.5 m steps, one turn)
    with sequential edges to the 4 predecessors (the reference's PGO wiring,
    ``mloam_loop/src/pose_graph.cpp:555-569``) plus ``n_loops`` long-range
    loop closures, all measured exactly. Returns (noisy poses, edges, ground
    truth); the noise is a tangent draw of ``noise`` per pose but the first,
    from a ``torch.Generator`` seeded ``seed``. Built on the CPU in the JAX
    package's order of operations, then moved to ``device``."""
    device = resolve_device(device)
    step_rel = se3.exp(torch.tensor([0.5, 0, 0, 0, 0, 2 * math.pi / n]))
    q = [torch.tensor([1.0, 0, 0, 0])]
    t = [torch.zeros(3)]
    for _ in range(n - 1):
        nxt = se3.compose(Pose(q[-1], t[-1]), step_rel)
        q.append(nxt.q)
        t.append(nxt.t)
    gt = Pose(torch.stack(q), torch.stack(t))
    ei, ej = [], []
    for sk in (1, 2, 3, 4):
        ei += list(range(0, n - sk))
        ej += list(range(sk, n))
    for k in range(n_loops):
        a = (k * n) // n_loops
        ei.append(a)
        ej.append((a + n // 2) % n)
    ei_a = torch.tensor(ei, dtype=torch.int64)
    ej_a = torch.tensor(ej, dtype=torch.int64)
    rel = se3.relative(Pose(gt.q[ei_a], gt.t[ei_a]), Pose(gt.q[ej_a], gt.t[ej_a]))
    edges = PoseGraphEdges(i=ei_a, j=ej_a, z_q=rel.q, z_t=rel.t,
                           weight=torch.ones((ei_a.shape[0], 6)))
    dn = noise * torch.randn((n, 6), generator=torch.Generator().manual_seed(seed))
    dn[0] = 0.0
    noisy = se3.boxplus(gt, dn)

    def dev(p):
        return type(p)(*(x.to(device) for x in p))

    return dev(noisy), dev(edges), dev(gt)
