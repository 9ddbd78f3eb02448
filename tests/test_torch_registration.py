"""Loop registration (coarse align + LOAM-factor refinement), port vs JAX
package, on keyframes rendered and featurised by the JAX package
(``tests/torch_loop_case.py``).

The query is the revisit keyframe (the circle's start seen again), the
target the first keyframe's clouds; the refinement starts from the coarse
yaw with a translation seed 0.3 m off, and from a seed outside the
basin. Held: ``coarse_align`` to 1e-5; ``fine_register``'s pose to 1e-4
(quaternion components, metres), cost to 1e-3 relative (a mean of f32
squared residuals), inlier fraction within one point of the JAX package's,
``ok`` equal. The port's normal equations are closed form, the JAX
package's a jacfwd of the same residuals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mloam_tpu.core.se3 import Pose as JPose
from mloam_tpu.loop import registration as JREG
from mloam_tpu_torch.core.se3 import Pose as TPose
from mloam_tpu_torch.loop import registration as TREG
from mloam_tpu_torch.utils import convert
from torch_loop_case import N, configs, keyframes, np_

JCFG, TCFG, _, _ = configs()
j_fine = jax.jit(JREG.fine_register, static_argnames=("cfg",))


@pytest.fixture(scope="module")
def pair():
    kfs = keyframes()
    _, _, tc, ts = kfs[0]
    _, _, qc, qs = kfs[-1]
    return (qc, qs, tc, ts), tuple(convert.featcloud_from_numpy(np_(x)) for x in (qc, qs, tc, ts))


def test_coarse_align(pair):
    (qc, qs, tc, ts), (tqc, tqs, ttc, tts) = pair
    for yaw in (0.0, 0.4, -2.5):
        j = JREG.coarse_align(qs.xyz, qs.mask, ts.xyz, ts.mask, jnp.asarray(yaw))
        t = TREG.coarse_align(tqs.xyz, tqs.mask, tts.xyz, tts.mask, torch.tensor(yaw))
        np.testing.assert_allclose(N(t.q), N(j.q), atol=1e-5)
        np.testing.assert_allclose(N(t.t), N(j.t), atol=1e-5)


@pytest.mark.parametrize("seed_t, want_ok", [((0.3, -0.2, 0.05), True),
                                             ((4.0, 3.0, 0.0), False)],
                         ids=["in_basin", "outside_basin"])
def test_fine_register(pair, seed_t, want_ok):
    (qc, qs, tc, ts), (tqc, tqs, ttc, tts) = pair
    q0 = np.array([np.cos(0.02), 0, 0, np.sin(0.02)], np.float32)
    t0 = np.asarray(seed_t, np.float32)
    j = j_fine(qc, qs, tc.xyz, tc.mask, ts.xyz, ts.mask,
               JPose(jnp.asarray(q0), jnp.asarray(t0)), cfg=JCFG)
    t = TREG.fine_register(tqc, tqs, ttc.xyz, ttc.mask, tts.xyz, tts.mask,
                           TPose(torch.from_numpy(q0), torch.from_numpy(t0)), TCFG)
    assert bool(t.ok) == bool(j.ok) == want_ok
    n_query = int(qs.mask.sum())
    assert abs(float(t.inlier_frac) - float(j.inlier_frac)) <= 1.0 / n_query + 1e-6
    if want_ok:
        np.testing.assert_allclose(N(t.pose.q), N(j.pose.q), atol=1e-4)
        np.testing.assert_allclose(N(t.pose.t), N(j.pose.t), atol=1e-4)
        assert float(t.cost) == pytest.approx(float(j.cost), rel=1e-3)
        # the revisit sits on the first keyframe: the edge is near identity
        assert float(torch.linalg.norm(t.pose.t)) < 0.1
        assert float(t.inlier_frac) > 0.5
