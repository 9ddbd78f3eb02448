"""pgo_gn_ms: the window's seconds (its opening to the end of its last
solve) over the Gauss-Newton steps of all its solves, in ms."""

from portbench import harness


def read(ctx):
    w = ctx.get("window")
    if not w or "steps" not in w:
        return None
    return harness.ms_per_unit(w["steps"], w["seconds"])
