"""The slice as a whole: ``FullPipeline`` (odometry + keyframe mapping), port
vs JAX package.

The same renderings (the JAX package's world and trajectory, 8x360 range
image, odometry caps 128/256, window 4/2: the fixture of
``test_torch_pipeline.py``) go through both pipelines with small mapping caps
for 10 sweeps: the mapper runs on sweeps 4, 6 and 8, the first passing
through. Each sweep starts on the port from the JAX pipeline's whole state
(odometry and mapper, carried across as numpy). On this poorly
conditioned 8-ring sensor one odometry sweep from the same state already
differs by up to 12 mm between the two sides (observed at the tenth sweep;
free-running they part by 5 mm at the fourth, the drift
``test_torch_pipeline.py`` bounds over 7 sweeps). So the mapper's own
results are held: on every mapped sweep the map-frame pose, and on every
sweep the drift correction map_pose ∘ odom_pose⁻¹, to the odometry's bound
of 1 cm / 2 mrad; the mapper's insertion decision, keyframe count and ring
cursor must be equal.
Then the counterparts
of ``tests/test_mapping.py::TestUncertaintyAwareMapping`` and of
``tests/test_design_limits.py::test_full_pipeline_across_wrap`` (at a ring of
four).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mloam_tpu.core.rangeimage import LidarModel as JModel
from mloam_tpu.core.rangeimage import RangeImage as JRangeImage
from mloam_tpu.models import platforms as jplatforms
from mloam_tpu.models.pipeline import FullPipeline as JFull
from mloam_tpu.sim import world as JW
from mloam_tpu_torch.core import se3 as tse3
from mloam_tpu_torch.mapping import mapper as TMP
from mloam_tpu_torch.models import platforms
from mloam_tpu_torch.models.pipeline import FullPipeline
from mloam_tpu_torch.utils import convert, evaluation

N_FRAMES = 10


def N(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def small_cfg(**mapping):
    mapping = {"max_keyframes": 16, **mapping}
    j = jplatforms.synthetic(n_lidars=1)
    j = dataclasses.replace(
        j,
        rig=dataclasses.replace(j.rig, models=(JModel(n_rings=8, n_cols=360),)),
        features=dataclasses.replace(j.features, cap_less_flat=512),
        odometry=dataclasses.replace(
            j.odometry, window_size=4, opt_window_size=2, cap_frame_corner=128,
            cap_frame_surf=256, localmap_precap_corner=256,
            localmap_precap_surf=640),
        mapping=dataclasses.replace(
            j.mapping, cap_map_corner=2048, cap_map_surf=4096,
            cap_frame_outlier=64, **mapping))
    return j, convert.config_from_reference(dataclasses.asdict(j))


def load_state(tp, jp):
    """Give the port's FullPipeline the JAX pipeline's whole state (one
    lidar, mode 0)."""
    np_ = lambda x: jax.tree.map(np.asarray, x)  # noqa: E731
    pose = lambda p: convert.pose_from_numpy(np_(p))  # noqa: E731
    to, jo = tp.odom, jp.odom
    to.frame_idx = jo.frame_idx
    to.window = convert.window_state_from_numpy(np_(jo.window))
    to.prev_feats = [None if f is None else convert.feature_frame_from_numpy(np_(f))
                     for f in jo.prev_feats]
    to.motions = [pose(m) for m in jo.motions]
    to.world_pose = pose(jo.world_pose)
    tp.mapper_state = convert.mapper_state_from_numpy(np_(jp.mapper_state))


@pytest.fixture(scope="module")
def runs():
    jcfg, tcfg = small_cfg()
    jw = JW.make_world(jax.random.PRNGKey(0))
    jtraj = JW.make_trajectory(jax.random.PRNGKey(1))
    jimgs, jgt = JW.render_sequence(jw, jtraj, jcfg.rig.models[0], N_FRAMES)
    jpipe, tpipe = JFull(jcfg), FullPipeline(tcfg, device="cpu")
    jout, tout = [], []
    for i in range(N_FRAMES):
        load_state(tpipe, jpipe)
        tout.append(tpipe.process([convert.range_image_from_numpy(
            tuple(np.asarray(f[i]) for f in jimgs))]))
        jout.append(jpipe.process([JRangeImage(*(f[i] for f in jimgs))]))
        assert int(tpipe.mapper_state.db.head) == int(jpipe.mapper_state.db.head)
        assert int(tpipe.mapper_state.db.valid.sum()) == \
            int(jpipe.mapper_state.db.valid.sum())
    return jpipe, tpipe, jout, tout, np.asarray(jgt.t[:N_FRAMES])


def test_map_pose_matches_reference(runs):
    jpipe, tpipe, jout, tout, gt = runs
    assert [o.mapped for o in tout] == [o.mapped for o in jout]
    assert [i for i, o in enumerate(tout) if o.mapped] == [4, 6, 8]
    def stack(outs, f):
        return tse3.Pose(*(torch.tensor(np.stack([N(getattr(f(o), k)) for o in outs]))
                           for k in ("q", "t")))

    def bounded(a, b):
        d = tse3.boxminus(a, b)
        assert float(d[:, :3].norm(dim=-1).max()) < 0.01       # 1 cm
        assert float(d[:, 3:].norm(dim=-1).max()) < 2e-3       # 2 mrad

    mapped = [i for i, o in enumerate(tout) if o.mapped]
    bounded(stack([tout[i] for i in mapped], lambda o: o.map_pose),
            stack([jout[i] for i in mapped], lambda o: o.map_pose))

    def correction(outs):
        m, o = stack(outs, lambda o: o.map_pose), stack(outs, lambda o: o.odom.pose)
        return tse3.compose(m, tse3.inverse(o))

    bounded(correction(tout), correction(jout))
    tt = torch.stack([o.map_pose.t for o in tout])
    assert int(tpipe.mapper_state.db.valid.sum()) == int(jpipe.mapper_state.db.valid.sum())
    assert int(tpipe.mapper_state.db.head) == int(jpipe.mapper_state.db.head)
    assert tpipe.mapper_state.step == int(jpipe.mapper_state.step) == 3
    for t, j in zip(tout, jout):
        if t.mapped:
            assert bool(t.inserted_kf) == bool(j.inserted_kf)
            assert t.map_cov.shape == (6, 6)
            assert (torch.linalg.eigvalsh(t.map_cov) > -1e-6).all()
    assert evaluation.ate_rmse(N(tt), gt) < 0.05


def test_keyframes_hold_the_merged_clouds_and_outliers(runs):
    jpipe, tpipe, *_ = runs
    tdb, jdb = tpipe.mapper_state.db, jpipe.mapper_state.db
    valid = N(tdb.valid)
    assert valid.sum() >= 2
    for name in ("corner", "surf", "outlier"):
        np.testing.assert_array_equal(N(getattr(tdb, name).mask)[valid],
                                      np.asarray(getattr(jdb, name).mask)[valid])
    assert N(tdb.outlier.mask)[valid].any()
    assert np.isfinite(N(tdb.outlier.xyz)[valid]).all()
    assert (np.linalg.eigvalsh(N(tdb.cov)[valid]) > -1e-6).all()
    corner, surf = tpipe.last_merged
    assert corner.xyz.shape == (128, 3) and surf.xyz.shape == (256, 3)


class TestUncertaintyAwareMapping:
    def test_install_ext_cov_overrides_prior(self):
        cfg = platforms.synthetic(n_lidars=2)
        cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(
            cfg.mapping, max_keyframes=2, cap_map_corner=8, cap_map_surf=8))
        pipe = FullPipeline(cfg, device="cpu")
        assert float(pipe.mapper_state.ext_cov.abs().max()) == 0
        pipe.odom.ext_cov = 5e-4 * np.eye(6, dtype=np.float32)[None]
        pipe._install_ext_cov()
        ec = pipe.mapper_state.ext_cov.numpy()
        np.testing.assert_allclose(ec[0], 0.0)
        np.testing.assert_allclose(np.diag(ec[1]), 5e-4, rtol=1e-6)
        assert pipe._ext_cov_installed

    def test_point_cov_per_lidar_segments(self):
        from mloam_tpu.core.se3 import Pose as JPose
        from mloam_tpu.mapping.mapper import _point_cov as j_point_cov

        n = 8
        xyz = np.concatenate([np.tile([[5.0, 0, 0]], (n, 1)),
                              np.tile([[5.0, 0, 0]], (n, 1))]).astype(np.float32)
        ext_cov = np.stack([np.zeros((6, 6)), np.eye(6)]).astype(np.float32)
        cov = TMP._point_cov(torch.from_numpy(xyz), tse3.Pose.identity(),
                             torch.zeros(6, 6), torch.from_numpy(ext_cov),
                             1e-6 * torch.eye(3))
        tr = N(torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1))
        assert tr[:n].max() < 1e-4
        assert tr[n:].min() > 1.0  # rotation lever arm at 5 m range
        j = j_point_cov(jnp.asarray(xyz), JPose.identity(), jnp.zeros((6, 6)),
                        jnp.asarray(ext_cov), 1e-6 * jnp.eye(3))
        np.testing.assert_allclose(N(cov), np.asarray(j), rtol=0, atol=1e-6)
        # an uneven concatenation falls back to the lidar mean
        odd = TMP._point_cov(torch.from_numpy(xyz[:15]), tse3.Pose.identity(),
                             torch.zeros(6, 6), torch.from_numpy(ext_cov),
                             1e-6 * torch.eye(3))
        jo = j_point_cov(jnp.asarray(xyz[:15]), JPose.identity(), jnp.zeros((6, 6)),
                         jnp.asarray(ext_cov), 1e-6 * jnp.eye(3))
        np.testing.assert_allclose(N(odd), np.asarray(jo), rtol=0, atol=1e-6)


def test_full_pipeline_across_wrap():
    """Drive FullPipeline past a ring of four: insertions exceed the
    capacity, the mapped trajectory stays finite and near the truth across
    the overwrite boundary, and every slot holds a keyframe."""
    from mloam_tpu_torch.models import run_synthetic

    _, tcfg = small_cfg(max_keyframes=4, keyframe_dist=0.2, keyframe_angle_deg=2.0)
    seen = {}
    res = run_synthetic.run(n_frames=16, seed=0, verbose=False, device="cpu",
                            cfg=tcfg, mapping=True,
                            on_sweep=lambda i, out, pipe: seen.update(pipe=pipe))
    pipe = seen["pipe"]
    assert int(pipe.mapper_state.db.head) > 4, "ring never wrapped"
    assert bool(pipe.mapper_state.db.valid.all())
    assert np.isfinite(res["map_est_t"]).all()
    # the truth relative to the first sweep, the map frame's origin
    g0 = tse3.Pose(torch.from_numpy(res["gt_q"][0]), torch.from_numpy(res["gt_t"][0]))
    gt_rel = tse3.compose(tse3.inverse(g0), tse3.Pose(torch.from_numpy(res["gt_q"]),
                                                      torch.from_numpy(res["gt_t"]))).t
    err = np.linalg.norm(res["map_est_t"] - gt_rel.numpy(), axis=1)
    assert float(err.max()) < 1.0, f"wrapped-map drift {err.max():.2f}"
    assert res["map_ate_m"] < 0.05
    assert res["mapped"] == [i >= 4 and i % 2 == 0 for i in range(16)]
