"""Device time per request of the ion-ion pair kernel (the kernels whose
names hold ``ion_pair``), in the profiled requests: one energy sum in
``place_ions`` and one sum with gradients in ``forces`` each.  None where
the trace holds no such kernel (a program without it)."""

from harness.pair_roofline import ION_PAIR_KERNELS


def read(ctx):
    if ctx.trace is None or not ctx.n_profiled:
        return None
    s = ctx.trace.kernel_s(ION_PAIR_KERNELS)
    return 1e3 * s / ctx.n_profiled if s > 0 else None
