"""Mean host time per request of ``System.place_ions``, from the benchmark's
span around the call, which ends in a device synchronisation (the
profiled requests left out)."""


def read(ctx):
    return ctx.spans.mean_ms("place_ions", ctx.skip)
