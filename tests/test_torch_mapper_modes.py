"""``mapping/mapper.mapper_step`` in its other loss modes and with the armed
degeneracy gate, port vs JAX package: Geman-McClure, the graduated (GNC)
surrogate, and the persistence-gated remap. Ten steps each of the case in
``torch_mapper_case.py``, every step started on both sides from the same JAX
state and held as in ``test_torch_mapper.py``. The good-feature selection
methods are in ``test_torch_mapper_selection.py``.
"""

import pytest

import torch_mapper_case as case

STEPS = 10

MODES = {
    "gm": dict(loss_mode="gm", gm_c=0.3),
    "gnc_gm": dict(loss_mode="gnc_gm", gm_c=0.3),
    # the persistence gate engages from the third consecutive weak step
    "armed_gate": dict(eig_threshold=175.0),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_matches_reference(mode):
    jcfg, tcfg = case.configs(**MODES[mode])
    recs, _ = case.compare_steps(jcfg, tcfg, case.sequence(STEPS, seed=1))
    mapped = recs[1:]
    assert any(r["stale"] for r in mapped) and any(not r["stale"] for r in mapped)
    assert min(r["n_surf"] for r in mapped) > 0
    assert sum(r["noise_step"] for r in recs) <= 2
    if mode == "armed_gate":
        # the gate built up persistence and froze a direction
        assert max(r["deg_count"] for r in recs) >= 3
        assert max(r["frozen"] for r in recs) > 0.5
