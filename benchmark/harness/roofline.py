"""The yardstick of the kernel metrics: the card's published peaks, the
bytes a fused spectral convolution must move, and its bound time.

The hand kernel ``irfftn(K * rfftn(x))`` over (B lanes of) an
(n0, n1, n2) grid reads x and K once and writes y once: per lane
2 n0 n1 n2 s + n0 n1 (n2 // 2 + 1) s bytes for an item size s (K is one
half-spectrum per lane on the paths the cells run).  Its FFT work is
O(N log N) flops at a few per byte, far below the ridge point, so the
bound is the bytes at the HBM bandwidth.
"""

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flops": 67e12,
    "fp64_flops": 34e12,
}


def spectral_conv_bytes(shape, lanes, itemsize):
    n0, n1, n2 = shape
    field = n0 * n1 * n2 * itemsize
    half = n0 * n1 * (n2 // 2 + 1) * itemsize
    return lanes * (2 * field + half)


def spectral_conv_bound_s(shape, lanes, itemsize, calls):
    return calls * spectral_conv_bytes(shape, lanes, itemsize) \
        / PEAKS["hbm_bytes_per_s"]


def roofline_pct(bound_s, device_s):
    """Share of the bound in the measured device time, in percent; None
    where the trace holds none of the kernel's time."""
    if not device_s or device_s <= 0:
        return None
    return 100.0 * bound_s / device_s
