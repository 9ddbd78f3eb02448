"""Port vs JAX package: the simulator fixtures of the degeneracy and
robust-loss courses — the corridor world, the straight trajectory,
companions (objects riding with the vehicle, in bursts) and movers
(cross-traffic) — and the per-frame range noise.

The corridor is fixed geometry (no draw), so it must equal the JAX
package's field by field, and the straight course's poses agree to 1e-6.
Renders with companions or movers are held to the render tolerance of
``tests/test_torch_pipeline.py``: at most one ray in 20160 hit on one side
only (a ray grazing an edge), ranges within 1e-4 m but for 0.5 % of the
rays (grazing the ground far out), none beyond 5 mm. Range noise is drawn by
another generator than JAX's; what is held is that frame i's draw depends on
``(noise_seed, i)`` alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mloam_tpu.core.rangeimage import LidarModel as JModel
from mloam_tpu.core.se3 import Pose as JPose
from mloam_tpu.sim import world as JW
from mloam_tpu_torch.core.rangeimage import LidarModel
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.sim import world as TW
from mloam_tpu_torch.utils import convert

N_FRAMES = 7
JMODEL = JModel(n_rings=8, n_cols=360, max_range=20.0)
TMODEL = LidarModel(n_rings=8, n_cols=360, max_range=20.0)
MOUNT_T = (0.0, 0.0, 1.2)
# the JAX package's robust-loss course: three cylinders crossing the scene
MOVERS = (np.array([[5.0, 2.0, 0.6], [-3.0, 6.0, 0.6], [7.0, -4.0, 0.5]], np.float32),
          np.broadcast_to(np.array([0.0, 2.5], np.float32), (3, 2)).copy(),
          np.array([[-1.2, -0.5], [0.8, -1.4], [-0.6, 1.3]], np.float32))


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_renders_agree(timgs, jimgs):
    jv, tv = N(jimgs.valid), N(timgs.valid)
    assert (jv != tv).sum() <= max(1, jv.size // 20160)
    assert tv.mean() > 0.3
    both = jv & tv
    err = np.abs(N(timgs.rng)[both] - N(jimgs.rng)[both])
    assert (err > 1e-4).mean() < 0.005
    assert err.max() < 5e-3


@pytest.mark.parametrize("kw", [{}, {"ceiling": False, "rails": False},
                                {"featured_entry": False, "wall_height": 3.0}],
                         ids=["default", "open_no_rails", "no_entry_poles"])
def test_corridor_world_equals_reference_field_by_field(kw):
    t = TW.make_corridor_world(device="cpu", **kw)
    j = JW.make_corridor_world(**kw)
    assert t._fields == j._fields
    for name, a, b in zip(t._fields, t, j):
        assert a.shape == b.shape, name
        assert a.dtype == (torch.bool if name.endswith("mask") else torch.float32), name
        np.testing.assert_array_equal(N(a), N(b), err_msg=name)


def test_straight_trajectory_poses_match_reference():
    t = TW.make_straight_trajectory(speed=2.0, wobble=0.02, device="cpu")
    j = JW.make_straight_trajectory(speed=2.0, wobble=0.02)
    for ts in (0.0, 0.1, 1.7, 4.5, 8.9):
        tp, jp = t.pose(ts), j.pose(ts)
        np.testing.assert_allclose(N(tp.t), N(jp.t), atol=1e-6)
        np.testing.assert_allclose(N(tp.q), N(jp.q), atol=1e-6)
    # ~2 m/s along +x: x = 200 sin(0.01 t), 8.99696 m at 4.5 s
    assert abs(float(t.pose(4.5).t[0]) - 200 * np.sin(0.045)) < 1e-4


@pytest.fixture(scope="module")
def corridor():
    jw = JW.make_corridor_world(wall_height=3.0, ceiling=True)
    jtraj = JW.make_straight_trajectory(speed=2.0, wobble=0.02)
    return jw, jtraj, convert.world_from_numpy(jax.tree.map(np.asarray, jw)), \
        convert.trajectory_from_numpy((np.asarray(jtraj.amp), np.asarray(jtraj.freq),
                                       np.asarray(jtraj.phase), jtraj.yaw_rate,
                                       jtraj.wobble))


def test_companion_bursts_render_like_reference(corridor):
    """A companion 5 m ahead riding with the vehicle, present 3 frames of
    every 10 from frame 2: frames 2-4 hold it, 0-1 and 5-6 do not."""
    jw, jtraj, tw, ttraj = corridor
    comp = np.array([[5.0, 0.8, 0.12]], np.float32)
    kw = dict(companion_frames=(2, N_FRAMES), companion_period=(3, 10))
    jimgs, _ = JW.render_sequence(jw, jtraj, JMODEL, N_FRAMES, extrinsic=JPose(
        jnp.array([1.0, 0, 0, 0]), jnp.array(MOUNT_T)), companions=jnp.asarray(comp), **kw)
    timgs, _ = TW.render_sequence(tw, ttraj, TMODEL, N_FRAMES, device="cpu", extrinsic=Pose(
        torch.tensor([1.0, 0, 0, 0]), torch.tensor(MOUNT_T)), companions=torch.from_numpy(comp),
        **kw)
    assert_renders_agree(timgs, jimgs)
    plain, _ = TW.render_sequence(tw, ttraj, TMODEL, N_FRAMES, device="cpu", extrinsic=Pose(
        torch.tensor([1.0, 0, 0, 0]), torch.tensor(MOUNT_T)))
    changed = [int((N(timgs.rng[i]) != N(plain.rng[i])).sum()) for i in range(N_FRAMES)]
    assert [c > 0 for c in changed] == [False, False, True, True, True, False, False]


def test_movers_render_like_reference():
    jw = JW.make_world(jax.random.PRNGKey(0))
    jtraj = JW.make_trajectory(jax.random.PRNGKey(1), wobble=0.05)
    tw = convert.world_from_numpy(jax.tree.map(np.asarray, jw))
    ttraj = convert.trajectory_from_numpy((np.asarray(jtraj.amp), np.asarray(jtraj.freq),
                                           np.asarray(jtraj.phase), jtraj.yaw_rate,
                                           jtraj.wobble))
    model_j, model_t = JModel(n_rings=8, n_cols=360), LidarModel(n_rings=8, n_cols=360)
    jimgs, jgt = JW.render_sequence(jw, jtraj, model_j, N_FRAMES,
                                    movers=tuple(jnp.asarray(m) for m in MOVERS))
    timgs, tgt = TW.render_sequence(tw, ttraj, model_t, N_FRAMES, device="cpu",
                                    movers=tuple(torch.from_numpy(m) for m in MOVERS))
    np.testing.assert_allclose(N(tgt.t), N(jgt.t), atol=1e-6)
    assert_renders_agree(timgs, jimgs)
    # the movers are in the scene and move: the rays they take change
    plain, _ = TW.render_sequence(tw, ttraj, model_t, N_FRAMES, device="cpu")
    hit = N(timgs.rng) != N(plain.rng)
    assert all(hit[i].sum() > 0 for i in range(N_FRAMES))
    assert not np.array_equal(hit[0], hit[-1])


def test_frame_noise_depends_only_on_seed_and_index(corridor):
    """Frame i's noise is the draw of a generator seeded by
    ``(noise_seed, i)``: a shorter render repeats the frames it shares, and
    noise minus the noiseless render is that draw times the deviation."""
    _, _, tw, ttraj = corridor
    kw = dict(device="cpu", noise_std=0.01, noise_seed=1000)
    long, _ = TW.render_sequence(tw, ttraj, TMODEL, 4, **kw)
    short, _ = TW.render_sequence(tw, ttraj, TMODEL, 2, **kw)
    for f in ("rng", "valid", "xyz"):
        assert torch.equal(getattr(long, f)[:2], getattr(short, f))
    plain, _ = TW.render_sequence(tw, ttraj, TMODEL, 4, device="cpu")
    for i in range(4):
        g = torch.Generator().manual_seed(TW.frame_noise_seed(1000, i))
        draw = torch.randn((8, 360), generator=g)
        both = long.valid[i] & plain.valid[i]
        # the range is re-derived from xyz: within a few ulp of a 20 m range
        np.testing.assert_allclose(N(long.rng[i] - plain.rng[i])[N(both)],
                                   N(0.01 * draw)[N(both)], atol=8e-6)
    other, _ = TW.render_sequence(tw, ttraj, TMODEL, 2, device="cpu", noise_std=0.01,
                                  noise_seed=1001)
    assert not torch.equal(other.rng, short.rng)
    seeds = {TW.frame_noise_seed(s, i) for s in (1000, 1001, 2000) for i in range(64)}
    assert len(seeds) == 3 * 64
