"""Port vs JAX package: the tracker-less steady path (``tracker.skip_steady``)
of ``OdometryPipeline`` under ``indoor_degenerate``, on the corridor course
of ``tests/torch_corridor_case.py``, sweep by sweep.

Each sweep starts the port from the JAX pipeline's state (window, motions,
previous features, pose), so each is held on the same inputs: the refined
pose within 1 cm / 2 mrad (the bound of ``tests/test_torch_pipeline.py``)
and the directions the window's projector froze equal. Steady sweeps carry
no tracker spectrum, and the next motion is the refined inter-sweep motion
read off the window. ``process_chunk`` over the steady sweeps equals the
``process`` calls it replaces, to the bit.
"""

import jax
import numpy as np
import pytest
import torch

from mloam_tpu.core.rangeimage import RangeImage as JRangeImage
from mloam_tpu.models.pipeline import OdometryPipeline as JPipeline
from mloam_tpu_torch.core import se3 as tse3
from mloam_tpu_torch.core.rangeimage import RangeImage
from mloam_tpu_torch.models.pipeline import OdometryPipeline
from mloam_tpu_torch.utils import convert
from torch_corridor_case import N, configs, load_state, render, tframe

N_SWEEPS = 10


@pytest.fixture(scope="module")
def course():
    jcfg, tcfg = configs()
    imgs, gt = render(jcfg, N_SWEEPS)
    return jcfg, tcfg, imgs


def test_skip_steady_matches_reference_sweep_by_sweep(course):
    jcfg, tcfg, imgs = course
    jpipe, tpipe = JPipeline(jcfg), OdometryPipeline(tcfg, device="cpu")
    frozen = []
    for i in range(N_SWEEPS):
        load_state(tpipe, jpipe)
        jo = jpipe.process([JRangeImage(*(f[i] for f in imgs))])
        to = tpipe.process([tframe(imgs, i)])
        d = tse3.boxminus(to.pose, convert.pose_from_numpy(jax.tree.map(np.asarray, jo.pose)))
        assert float(d[:3].norm()) < 0.01, f"sweep {i}"      # 1 cm
        assert float(d[3:].norm()) < 2e-3, f"sweep {i}"      # 2 mrad
        assert (to.win_frozen is None) == (jo.win_frozen is None), f"sweep {i}"
        if jo.win_frozen is not None:
            np.testing.assert_array_equal(N(to.win_frozen), N(jo.win_frozen))
            frozen.append(float(N(to.win_frozen).sum()))
        steady = i >= tcfg.odometry.window_size
        if steady:
            assert to.trk_eig is None and jo.trk_eig is None, f"sweep {i}"
            # the next motion is the refined motion between the last two poses
            w = tpipe.window
            want = tse3.compose(tse3.inverse(tse3.Pose(w.poses.q[-2], w.poses.t[-2])),
                                tse3.Pose(w.poses.q[-1], w.poses.t[-1]))
            assert torch.equal(tpipe.motions[0].t, want.t)
            jm = convert.pose_from_numpy(jax.tree.map(np.asarray, jpipe.motions[0]))
            dm = tse3.boxminus(tpipe.motions[0], jm)
            assert float(dm[:3].norm()) < 0.01 and float(dm[3:].norm()) < 2e-3
    # the gate engaged on this course, and stayed off while it counted up
    assert frozen[0] == 0 and max(frozen) > 0


def test_skip_steady_chunk_equals_streaming(course):
    _, tcfg, imgs = course
    ws = tcfg.odometry.window_size
    frames = [tframe(imgs, i) for i in range(N_SWEEPS)]
    a = OdometryPipeline(tcfg, device="cpu")
    outs = [a.process([f]) for f in frames]
    b = OdometryPipeline(tcfg, device="cpu")
    for f in frames[:ws]:
        b.process([f])
    tail = RangeImage(*(torch.stack(x) for x in zip(*frames[ws:])))
    q, t, pq, pt, cost, nc, ns = b.process_chunk(tail)
    assert torch.equal(t, torch.stack([o.pose.t for o in outs[ws:]]))
    assert torch.equal(q, torch.stack([o.pose.q for o in outs[ws:]]))
    assert torch.equal(pt, torch.stack([o.pose_predict.t for o in outs[ws:]]))
    assert torch.equal(cost, torch.stack([o.cost for o in outs[ws:]]))
    assert torch.equal(b.window.prior.H, a.window.prior.H)
    assert torch.equal(b.window.deg_count, a.window.deg_count)
    assert torch.equal(b.motions[0].t, a.motions[0].t)
    assert b.frame_idx == a.frame_idx == N_SWEEPS
