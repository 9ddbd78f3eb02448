"""Port vs JAX package: the tracker-less steady path on a dual rig
(``tracker.skip_steady`` with ``indoor_degenerate``, extrinsics known,
ESTIMATE_EXTRINSIC 0) on the corridor course of
``tests/torch_corridor_case.py``, sweep by sweep from the JAX state.

Lidar 1 sits 30 degrees of yaw and 38 cm off lidar 0 (the rig of
``tests/test_torch_rig.py``). The constant-velocity motion seeds the window
and de-skews both lidars, each through its extrinsic; no tracker runs on a
steady sweep. Held: the refined pose within 1 cm / 2 mrad and the frozen
directions equal, on every sweep; ``process_chunk`` equal to streaming.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mloam_tpu.core import se3 as jse3
from mloam_tpu.core.rangeimage import RangeImage as JRangeImage
from mloam_tpu.models.pipeline import OdometryPipeline as JPipeline
from mloam_tpu.odometry import estimator as JE
from mloam_tpu_torch.core import se3 as tse3
from mloam_tpu_torch.core.rangeimage import RangeImage
from mloam_tpu_torch.models.pipeline import OdometryPipeline
from mloam_tpu_torch.utils import convert
from torch_corridor_case import N, configs, load_state, render, tframe

N_SWEEPS = 9
X_Q, X_T = [0.9659258, 0.0, 0.0, 0.258819], [0.3, -0.2, 0.1]


def test_dual_rig_skip_steady_matches_reference_sweep_by_sweep():
    jcfg, tcfg = configs(n_lidars=2)
    x1 = jse3.Pose(jnp.asarray(X_Q), jnp.asarray(X_T))
    seqs = (render(jcfg, N_SWEEPS)[0], render(jcfg, N_SWEEPS, extrinsic=x1)[0])
    I0 = jse3.Pose.identity()
    jext = jse3.Pose(jnp.stack([I0.q, x1.q]), jnp.stack([I0.t, x1.t]))
    jpipe = JPipeline(jcfg)
    jpipe.window = JE.set_extrinsics(jpipe.window, jext)
    tpipe = OdometryPipeline(tcfg, device="cpu")
    tpipe.set_extrinsics(convert.pose_from_numpy(jax.tree.map(np.asarray, jext)))
    outs = []
    for i in range(N_SWEEPS):
        load_state(tpipe, jpipe)
        jo = jpipe.process([JRangeImage(*(f[i] for f in s)) for s in seqs])
        to = tpipe.process([tframe(s, i) for s in seqs])
        assert to.ext_mode == 0
        d = tse3.boxminus(to.pose, convert.pose_from_numpy(jax.tree.map(np.asarray, jo.pose)))
        assert float(d[:3].norm()) < 0.01, f"sweep {i}"      # 1 cm
        assert float(d[3:].norm()) < 2e-3, f"sweep {i}"      # 2 mrad
        if jo.win_frozen is not None:
            np.testing.assert_array_equal(N(to.win_frozen), N(jo.win_frozen))
        if i >= tcfg.odometry.window_size:
            assert to.trk_eig is None and jo.trk_eig is None
        outs.append(to)

    # chunked replay of the steady sweeps equals streaming, to the bit
    ws = tcfg.odometry.window_size
    a, b = (OdometryPipeline(tcfg, device="cpu") for _ in range(2))
    for p in (a, b):
        p.set_extrinsics(convert.pose_from_numpy(jax.tree.map(np.asarray, jext)))
    frames = [[tframe(s, i) for s in seqs] for i in range(N_SWEEPS)]
    streamed = [a.process(f) for f in frames]
    for f in frames[:ws]:
        b.process(f)
    tail = tuple(RangeImage(*(torch.stack(x) for x in zip(*(f[l] for f in frames[ws:]))))
                 for l in range(2))
    q, t, *_ = b.process_chunk(tail)
    assert torch.equal(t, torch.stack([o.pose.t for o in streamed[ws:]]))
    assert torch.equal(q, torch.stack([o.pose.q for o in streamed[ws:]]))
    assert torch.equal(b.window.prior.H, a.window.prior.H)
