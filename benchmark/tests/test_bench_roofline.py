"""The yardstick's arithmetic at known shapes: the bytes and bound of the
fused spectral convolution, the roofline share, and the busy / idle
reduction of a trace, whole and inside a span."""

import pytest
import torch

import _paths  # noqa: F401
from harness import roofline
from harness.trace import Trace, busy_s


def test_spectral_conv_bytes_and_bound():
    # 128^3 f32: x and y 8 MiB each, K 128*128*65*4 bytes
    b = roofline.spectral_conv_bytes((128, 128, 128), 1, 4)
    assert b == 2 * 128 ** 3 * 4 + 128 * 128 * 65 * 4 == 21_037_056
    # nine lanes with a kernel each
    assert roofline.spectral_conv_bytes((95, 95, 117), 9, 4) == \
        9 * (2 * 95 * 95 * 117 * 4 + 95 * 95 * 59 * 4)
    t = roofline.spectral_conv_bound_s((128, 128, 128), 1, 4, 10)
    assert t == pytest.approx(10 * 21_037_056 / 3.35e12)
    assert roofline.spectral_conv_bound_s((128,) * 3, 1, 4, 10) \
        * 1e3 == pytest.approx(0.0628, abs=1e-4)


def test_roofline_pct():
    assert roofline.roofline_pct(1e-3, 1e-2) == pytest.approx(10.0)
    assert roofline.roofline_pct(1e-3, 0.0) is None


class _Ev:
    def __init__(self, name, start, dur, dev):
        self._n, self._s, self._d = name, start, dur
        self._t = (torch.autograd.DeviceType.CUDA if dev
                   else torch.autograd.DeviceType.CPU)

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._t


def test_trace_busy_idle_and_kernel_time():
    ev = [_Ev("void (anonymous namespace)::rfft_z<float, false>(...)", 100,
              50, True),
          _Ev("void (anonymous namespace)::fft_mid<float, false, true>", 120,
              60, True),                        # overlaps: union 100..180
          _Ev("regular_fft", 300, 100, True),
          _Ev("bench:forces", 150, 400, False),
          _Ev("aten::mul", 170, 80, False)]
    tr = Trace(ev, 0, 1000)
    assert tr.window_s == pytest.approx(1e-6)
    assert tr.busy_s == pytest.approx(180e-9)
    assert tr.kernel_s(("rfft_z<", "fft_mid<", "irfft_z<")) == \
        pytest.approx(110e-9)
    gaps = dict((n, s) for n, s in tr.idle_gaps())
    assert sum(gaps.values()) == pytest.approx(820e-9)
    assert gaps["forces/aten::mul"] == pytest.approx(120e-9)
    assert gaps["forces/python"] == pytest.approx(600e-9)
    assert tr.top_ops()[0][0] == "regular_fft"


def test_busy_time_whole_and_inside_spans():
    ev = [_Ev("k1", 100, 50, True), _Ev("k2", 120, 60, True),
          _Ev("memcpy DtoH", 400, 20, True),
          _Ev("bench:optimize_density", 90, 200, True),   # its device range
          _Ev("bench:optimize_density", 90, 200, False),
          _Ev("bench:forces", 350, 100, False),
          _Ev("cudaLaunchKernel", 95, 5, False)]
    # the union of 100..180 and 400..420; the span's own range is no work
    assert busy_s(ev) == pytest.approx(100e-9)
    tr = Trace(ev, 0, 1000)
    assert tr.busy_s == pytest.approx(100e-9)
    assert tr.span_busy_s("optimize_density") == pytest.approx(80e-9)
    assert tr.span_busy_s("forces") == pytest.approx(20e-9)
    assert tr.span_busy_s("place_ions") == 0
