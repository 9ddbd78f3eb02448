"""Port vs JAX package: the dual rig from unknown extrinsics
(ESTIMATE_EXTRINSIC 2) through the hand-eye switch to mode 1, sweep by
sweep, at the small width of ``tests/test_torch_rig.py`` (8x360 range
images, caps 128/256, window 4/2), whose helpers it shares."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mloam_tpu.core import se3 as jse3
from mloam_tpu.core.rangeimage import RangeImage as JRangeImage
from mloam_tpu.models.pipeline import OdometryPipeline as JPipeline
from mloam_tpu.sim import world as JW
from mloam_tpu_torch.core import se3 as tse3
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.models.pipeline import OdometryPipeline
from mloam_tpu_torch.utils import convert
from test_torch_rig import N, small_cfg, tframes


def load_state(tp, jp):
    """Give the port's pipeline the JAX pipeline's whole state."""
    np_ = lambda x: jax.tree.map(np.asarray, x)
    pose = lambda p: convert.pose_from_numpy(np_(p))
    tp.frame_idx, tp.ext_mode = jp.frame_idx, jp.ext_mode
    tp.window = convert.window_state_from_numpy(np_(jp.window))
    tp.prev_feats = [None if f is None else convert.feature_frame_from_numpy(np_(f))
                     for f in jp.prev_feats]
    tp.motions = [pose(m) for m in jp.motions]
    tp.world_pose = pose(jp.world_pose)
    tp.pair_accum = [pose(m) for m in jp.pair_accum]
    tp.calib_buffers = [convert.motion_buffer_from_numpy(np_(b)) for b in jp.calib_buffers]
    tp.ext_samples = [list(x) for x in jp.ext_samples]
    tp.ext_cov = jp.ext_cov


def test_dual_rig_in_mode_2_matches_reference_through_the_hand_eye_switch():
    """Mode 2 from unknown extrinsics against the JAX pipeline on the same
    renderings (lidar 1 at the JAX calibration program's extrinsic, wobble
    0.25): per-lidar tracking, pairs added every sweep (``pair_stride`` 1),
    the window solve on the reference lidar alone, and the hand-eye switch
    to mode 1, after which the window solve carries the extrinsic block. The
    rotation gate ``rot_converge_sv`` is 0 so that the hand-eye solve
    succeeds once the buffer holds 10 screw-consistent pairs (sweep 11),
    not after tens of sweeps.

    Each sweep starts the port from the JAX pipeline's whole state, so each
    sweep is held on the same inputs: equal mode, equal hand-eye buffer
    mask and head, the window's block count, poses (and from the switch on
    the extrinsic) within 1 cm / 2 mrad (observed: 3.2e-5 m and 4.5e-6 rad
    at most). Left to run free, the two part by up to 3 cm at sweep 9: the
    reference lidar alone (8 rings, no edge factors by sweep 6) constrains
    the window weakly (smallest eigenvalues 2-5 against ~900 for the prior
    block) and a 1e-5 m difference grows through the matching."""
    n = 13
    jcfg, tcfg = small_cfg(extrinsic_mode=2, pair_stride=1, rot_converge_sv=0.0)
    x_true = jse3.exp(jnp.array([0.25, -0.1, 0.05, 0.05, -0.03, 0.5]))
    w = JW.make_world(jax.random.PRNGKey(0))
    traj = JW.make_trajectory(jax.random.PRNGKey(1), wobble=0.25)
    model = jcfg.rig.models[0]
    seqs = (JW.render_sequence(w, traj, model, n)[0],
            JW.render_sequence(w, traj, model, n, extrinsic=x_true)[0])
    jpipe, tpipe_ = JPipeline(jcfg), OdometryPipeline(tcfg, device="cpu")
    modes = []
    for i in range(n):
        load_state(tpipe_, jpipe)
        jo = jpipe.process([JRangeImage(*(f[i] for f in s)) for s in seqs])
        to = tpipe_.process(tframes(seqs, i))
        assert to.ext_mode == jo.ext_mode, f"sweep {i}"
        modes.append(to.ext_mode)
        if jo.win_eig is not None:   # pose blocks, and the extrinsic's in mode 1
            assert to.win_eig.shape == jo.win_eig.shape, f"sweep {i}"
        for l in range(2):
            jb, tb = jpipe.calib_buffers[l], tpipe_.calib_buffers[l]
            assert int(tb.head) == int(jb.head), f"sweep {i}, lidar {l}"
            np.testing.assert_array_equal(N(tb.mask), N(jb.mask))
        pairs = [(to.pose, jo.pose)]
        if to.ext_mode < 2:
            pairs.append((Pose(to.extrinsics.q[1], to.extrinsics.t[1]),
                          jse3.Pose(jo.extrinsics.q[1], jo.extrinsics.t[1])))
        for tp, jp in pairs:
            d = tse3.boxminus(tp, Pose(torch.from_numpy(N(jp.q)), torch.from_numpy(N(jp.t))))
            assert float(d[:3].norm()) < 0.01, f"sweep {i}"     # 1 cm
            assert float(d[3:].norm()) < 2e-3, f"sweep {i}"     # 2 mrad
    # the switch sweep already solves with the extrinsic block, as JAX does
    assert modes == [2] * 11 + [1] * 2
