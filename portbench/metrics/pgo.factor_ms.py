"""pgo.factor_ms: device ms a Gauss-Newton step in the factorisation and
the triangular solves: the kernels launched under the host ops that the
profiler names ``aten::linalg_cholesky_ex`` and ``aten::cholesky_solve``
(their children included), over the traced steps."""

NAMES = ("aten::linalg_cholesky_ex", "aten::cholesky_solve")


def read(ctx):
    tr, steps = ctx.get("trace"), ctx.get("traced_steps")
    if tr is None or not steps:
        return None
    s = sum(tr.launched.get(n, 0.0) for n in NAMES)
    return s * 1e3 / steps if s > 0 else None
