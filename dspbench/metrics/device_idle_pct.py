"""device_idle_pct: the share of the traced stretch of the closed loop in
which no operation ran on the card, 100 (1 - busy / window), from the
device trace alone: the stretch runs the window's own loop, at most two
blocks in flight, with the profiler on, so the profiler's host cost a
block is in it."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or not tr.spans:
        return None
    w0, w1 = ctx.profile.window(tr)
    return 100.0 * (1.0 - ctx.profile.busy_s(tr) / (w1 - w0))
