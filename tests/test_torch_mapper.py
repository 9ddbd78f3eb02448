"""``mapping/mapper.mapper_step``, port vs JAX package, step by step.

Each step starts on both sides from the same JAX ``MapperState`` carried
across as numpy (``utils/convert.mapper_state_from_numpy``), so the
comparison holds every step on its own: pose within 1e-4 m / 1e-4 rad
(except the converged solver's last step at the f32 noise floor, see
``torch_mapper_case.compare_steps``), covariance within 1e-3 of its largest entry, equal insertion and staleness
decisions, equal match counts and the whole keyframe ring equal after the
step. The default configuration (huber loss, no feature selection, gate
disarmed) runs 22 steps: the pass-through first step, insertions, surround
rebuilds and reuses, and the ring of 8 wrapping. The other loss modes, the
armed gate and the feature-selection methods are in
``test_torch_mapper_modes.py``.
"""

import numpy as np
import pytest
import torch

import torch_mapper_case as case
from mloam_tpu_torch.mapping import mapper as TMP


@pytest.fixture(scope="module")
def default_run():
    jcfg, tcfg = case.configs()
    seq = case.sequence(22)
    recs, js = case.compare_steps(jcfg, tcfg, seq)
    return recs, js, seq


def test_sequence_covers_every_branch(default_run):
    recs, js, _ = default_run
    assert not recs[0]["mapped"] and recs[0]["inserted"]      # pass-through, insert
    mapped = recs[1:]
    assert any(r["stale"] for r in mapped) and any(not r["stale"] for r in mapped)
    assert any(r["inserted"] for r in mapped) and any(not r["inserted"] for r in mapped)
    assert recs[-1]["head"] > 8                                 # the ring wrapped
    assert bool(np.asarray(js.db.valid).all())
    # the map is matched against, in both classes
    assert min(r["n_surf"] for r in mapped) > 40
    assert min(r["n_corner"] for r in mapped) > 80
    # steps that end on the solver's noise floor stay the exception
    assert sum(r["noise_step"] for r in recs) <= 2


def test_mapped_poses_track_the_truth(default_run):
    """The drift correction works: the refined pose is nearer the truth than
    the drifting odometry at the end of the run."""
    _, js, seq = default_run
    (oq, ot), (q, t), *_ = seq[-1]
    corr = np.asarray(js.pose_map_odom.t)
    assert np.linalg.norm(ot - t) > 0.05
    last = np.asarray(js.last_kf_pose.t)
    assert np.linalg.norm(last - t) < 0.6
    assert np.isfinite(corr).all()


def test_one_stale_read_per_step_and_no_read_before_a_map():
    """The step reads the device once (the staleness), and the first step of
    a state passes through without matching."""
    jcfg, tcfg = case.configs()
    seq = case.sequence(3)
    st = TMP.init_state(tcfg, device="cpu")
    before = TMP.stale_reads
    outs = []
    for (oq, ot), _t, c, s, o in seq:
        from mloam_tpu_torch.core.se3 import Pose
        from mloam_tpu_torch.utils import convert
        st, out = TMP.mapper_step(st, Pose(torch.from_numpy(oq), torch.from_numpy(ot)),
                                  convert.featcloud_from_numpy(c),
                                  convert.featcloud_from_numpy(s), tcfg,
                                  outlier=convert.featcloud_from_numpy(o))
        outs.append(out)
    assert TMP.stale_reads - before == 3
    assert st.step == 3 and isinstance(st.step, int)
    assert float(outs[0].cost) == 0.0 and int(outs[0].n_surf) == 0
    assert torch.allclose(outs[0].cov, 1e-2 * torch.eye(6))
    assert outs[0].stale and outs[1].stale       # an insertion since assembly


def test_default_ext_cov_and_weight_curve():
    import dataclasses

    from mloam_tpu_torch.models import platforms

    cfg = platforms.synthetic(n_lidars=2)
    cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(
        cfg.mapping, ext_cov_prior_diag=(1e-3,) * 6, uct_ext_ratio=2.0))
    ec = TMP.default_ext_cov(cfg).numpy()
    assert ec.shape == (2, 6, 6)
    np.testing.assert_allclose(ec[0], 0.0)
    np.testing.assert_allclose(np.diag(ec[1]), 2e-3, rtol=1e-6)
    # the clamped sqrt-info weight (tests/test_mapping.py::test_uncertainty_weight_curve)
    tr = torch.tensor([1e-6, 0.05, 1.0 / 9.0, 0.25, 1.0, 4.0, 10.0, float("nan")])
    w = TMP.uncertainty_sqrt_info(tr).numpy()
    np.testing.assert_allclose(w[:3], 1.0, rtol=1e-5)
    np.testing.assert_allclose(w[3:7], [1 / 1.5, 1 / 3, 1 / 6, 1 / (3 * np.sqrt(10))],
                               rtol=1e-5)
    assert w[7] < 1e-3
