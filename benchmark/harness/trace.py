"""Reduction of a profiler trace of the traced sub-window: device busy
time (the union of kernel, copy and set intervals), the idle gaps between
them labelled by the benchmark span and the host operation that was
running, and the device operations that took most time; and the device
busy time of a whole window (``DeviceClock``)."""

import bisect
import time
from collections import defaultdict

import torch

SPECTRAL_CONV_KERNELS = ("rfft_z<", "fft_mid<", "irfft_z<")


def _is_device_op(e):
    # the spans' own ranges show on the device timeline too
    return (e.device_type() == torch.autograd.DeviceType.CUDA
            and not e.name().startswith("bench"))


def busy_s(events):
    """Device seconds in ``events``: the union of their kernel, copy and
    set intervals."""
    return 1e-9 * sum(b - a for a, b in _merge(
        [(e.start_ns(), e.start_ns() + e.duration_ns())
         for e in events if _is_device_op(e)]))


class DeviceClock:
    """Device busy time over a whole window, from profiler sessions that
    record device activity only, each over ``per_session`` requests, so
    that no session outgrows the tracer's buffers.  A session starts and
    stops between requests, after a synchronisation, so together they
    cover every operation the requests ran on the device."""

    def __init__(self, per_session):
        self.per_session = per_session
        self.requests = 0
        self.busy_s = 0.0
        self.sessions = []      # (requests, busy s, s spent in the tracer)
        self.prof = None
        # the tracer's first session initialises it: once, in set-up
        self.start()
        self.stop()
        self.busy_s = 0.0
        self.sessions = []

    def start(self):
        t = time.perf_counter()
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        self.r0, self.tracer_s = self.requests, time.perf_counter() - t

    def stop(self):
        torch.cuda.synchronize()
        t = time.perf_counter()
        self.prof.stop()
        busy = busy_s(self.prof.profiler.kineto_results.events())
        self.prof = None
        self.busy_s += busy
        self.sessions.append((self.requests - self.r0, busy, self.tracer_s
                              + time.perf_counter() - t))

    def request_done(self):
        self.requests += 1
        if self.requests % self.per_session == 0:
            self.stop()
            self.start()

    def close(self):
        if self.prof is not None:
            self.stop()
        return self.busy_s


class Trace:
    def __init__(self, events, t0_ns, t1_ns):
        self.window_s = (t1_ns - t0_ns) * 1e-9
        dev, cpu, spans = [], [], []
        for e in events:
            s, d = e.start_ns(), e.duration_ns()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not _is_device_op(e):
                    continue
                if s + d > t0_ns and s < t1_ns:
                    dev.append((max(s, t0_ns), min(s + d, t1_ns), e.name()))
            elif e.name().startswith("bench:"):
                spans.append((s, s + d, e.name()[6:]))
            elif e.name().startswith("aten::"):
                cpu.append((s, s + d, e.name()))
        self.dev = sorted(dev)
        self.cpu = sorted(cpu)
        self.spans = sorted(spans)
        self.busy_intervals = _merge([(a, b) for a, b, _ in self.dev])
        self.busy_s = sum(b - a for a, b in self.busy_intervals) * 1e-9
        self.t0, self.t1 = t0_ns, t1_ns

    def kernel_s(self, markers):
        """Device seconds of the kernels whose names hold one of
        ``markers``."""
        return 1e-9 * sum(b - a for a, b, n in self.dev
                          if any(m in n for m in markers))

    def span_busy_s(self, name):
        """Device busy seconds inside the benchmark spans named ``name``
        (each ends in a synchronisation, so its device work lies inside
        it)."""
        tot = 0
        for a, b, n in self.spans:
            if n == name:
                tot += sum(min(b, y) - max(a, x)
                           for x, y in self.busy_intervals if y > a and x < b)
        return tot * 1e-9

    def top_ops(self, k=10):
        tot = defaultdict(int)
        for a, b, n in self.dev:
            tot[_short(n)] += b - a
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[n, ns * 1e-9] for n, ns in top]

    def idle_gaps(self, k=10):
        """Idle device time summed by the label of what the host was doing
        at each gap's start: ``<span>/<innermost aten op>`` (``python``
        where no op was running)."""
        tot = defaultdict(int)
        edges = [self.t0] + [x for iv in self.busy_intervals for x in iv] \
            + [self.t1]
        starts = [c[0] for c in self.cpu]
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 <= g0:
                continue
            tot[f"{self._span_at(g0)}/{self._op_at(starts, g0)}"] += g1 - g0
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[n, ns * 1e-9] for n, ns in top]

    def _span_at(self, t):
        for a, b, n in self.spans:
            if a <= t <= b:
                return n
        return "between_calls"

    def _op_at(self, starts, t):
        i = bisect.bisect_right(starts, t)
        best = None
        for a, b, n in reversed(self.cpu[max(0, i - 256):i]):
            if b >= t and (best is None or a > best[0]):
                best = (a, n)
        return best[1] if best else "python"


def _merge(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _short(name, n=96):
    return name if len(name) <= n else name[:n]
