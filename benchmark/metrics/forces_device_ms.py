"""Device busy time per request inside the benchmark's span around
``System.forces``, in the profiled requests: the union of the
device operations that ran within the span, which ends in a
synchronisation."""


def read(ctx):
    if ctx.trace is None or not ctx.n_profiled:
        return None
    busy = ctx.trace.span_busy_s("forces")
    return 1e3 * busy / ctx.n_profiled if busy > 0 else None
