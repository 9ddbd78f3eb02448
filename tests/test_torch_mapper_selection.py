"""``mapping/mapper.mapper_step`` with good-feature selection, port vs JAX
package: the methods ``gd``, ``gd_float`` and ``fps``, ten steps each of the
case in ``torch_mapper_case.py``, every step started on both sides from the
same JAX state and held as in ``test_torch_mapper.py``. The ``rnd`` method
draws from another generator than the JAX package, so it is run on the port
alone and held to its ratio; its masks are held equal to the JAX package's
draw in ``test_torch_feature_selection.py``.
"""

import numpy as np
import pytest
import torch

import torch_mapper_case as case
from mloam_tpu_torch.core.se3 import Pose
from mloam_tpu_torch.mapping import mapper as TMP
from mloam_tpu_torch.utils import convert

STEPS = 10

MODES = {
    "gd": dict(gf_method="gd", gf_ratio=0.5),
    "gd_float": dict(gf_method="gd_float", gf_ratio=0.3, gf_ratio_degraded=0.8),
    "fps": dict(gf_method="fps", gf_ratio=0.5),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_matches_reference(mode):
    jcfg, tcfg = case.configs(**MODES[mode])
    recs, _ = case.compare_steps(jcfg, tcfg, case.sequence(STEPS, seed=1))
    mapped = recs[1:]
    assert any(r["stale"] for r in mapped) and any(not r["stale"] for r in mapped)
    assert min(r["n_surf"] for r in mapped) > 0
    assert sum(r["noise_step"] for r in recs) <= 2


def test_rnd_keeps_its_ratio_and_changes_its_draw_every_step():
    _, full = case.configs()
    _, rnd = case.configs(gf_method="rnd", gf_ratio=0.5)
    seq = case.sequence(6, seed=1)
    counts = {}
    for name, cfg in (("full", full), ("rnd", rnd)):
        st = TMP.init_state(cfg, device="cpu")
        counts[name] = []
        for (oq, ot), _t, c, s, o in seq:
            st, out = TMP.mapper_step(st, Pose(torch.from_numpy(oq), torch.from_numpy(ot)),
                                      convert.featcloud_from_numpy(c),
                                      convert.featcloud_from_numpy(s), cfg,
                                      outlier=convert.featcloud_from_numpy(o))
            counts[name].append(int(out.n_surf) + int(out.n_corner))
            assert torch.isfinite(out.pose.t).all() and torch.isfinite(out.cov).all()
    full_n, rnd_n = np.array(counts["full"][1:]), np.array(counts["rnd"][1:])
    # the selection applies to the last outer iteration's matches: about half
    frac = rnd_n.sum() / full_n.sum()
    assert 0.35 < frac < 0.65, frac
