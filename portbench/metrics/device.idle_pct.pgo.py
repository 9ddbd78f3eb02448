"""Share of the traced window (host wall, synchronised at both ends) in
which no device op ran: 100 * (1 - union of device intervals / window)."""

from portbench import trace as T


def read(ctx):
    tr = ctx.get("trace")
    return None if tr is None else T.idle_pct(tr)
