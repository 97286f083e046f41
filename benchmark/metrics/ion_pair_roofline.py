"""Share of the ion-ion pair sum's bound in the device time of its kernels,
in the profiled requests: each request's energy and forces sums over the
pairs within the cutoff at the card's FP64 peak
(``harness/pair_roofline.py``), against the summed durations of the
kernels whose names hold ``ion_pair``.  None where the trace holds no such
kernel."""

from harness.pair_roofline import (ION_PAIR_KERNELS, cell_geometry,
                                   request_bound_s)
from harness.roofline import roofline_pct


def read(ctx):
    if ctx.trace is None or not ctx.n_profiled:
        return None
    device_s = ctx.trace.kernel_s(ION_PAIR_KERNELS)
    geo = cell_geometry(ctx) if device_s > 0 else None
    if geo is None:
        return None
    return roofline_pct(ctx.n_profiled * request_bound_s(*geo), device_s)
