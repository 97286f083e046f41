"""Mean host time per request of ``System.forces``, from the benchmark's
span around the call, which ends in a device synchronisation (the
profiled requests left out)."""


def read(ctx):
    return ctx.spans.mean_ms("forces", ctx.skip)
