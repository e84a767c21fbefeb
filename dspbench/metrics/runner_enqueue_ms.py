"""runner_enqueue_ms: the host time of each StreamRunner call (the
enqueue), by the benchmark's own span around it, averaged over all
blocks of the window."""


def read(ctx):
    if not ctx.enqueue_s:
        return None
    return 1e3 * sum(ctx.enqueue_s) / len(ctx.enqueue_s)
