"""Share of the profiled requests' interval in which no device operation
ran: 100 (1 - busy / window), busy the union of the trace's kernel, copy
and set intervals."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
