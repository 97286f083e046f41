"""Share of the fused spectral convolution's bound in the device time of
its kernels, in the profiled requests: the calls counted by the port's
counter ``ops.spectral_conv.launches``, each bound by its bytes at the
HBM bandwidth (``harness/roofline.py``), against the summed durations of
its five launches in the profiler trace."""

from harness.roofline import roofline_pct, spectral_conv_bound_s
from harness.trace import SPECTRAL_CONV_KERNELS


def read(ctx):
    if ctx.trace is None or not ctx.spectral_conv_calls:
        return None
    bound = spectral_conv_bound_s(ctx.shape, ctx.lanes, ctx.itemsize,
                                  ctx.spectral_conv_calls)
    return roofline_pct(bound, ctx.trace.kernel_s(SPECTRAL_CONV_KERNELS))
