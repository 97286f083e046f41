"""Spans of the benchmark's own around the public calls it makes: host
time, ended by a device synchronisation, per request.  Off (no
synchronisation, nothing recorded) in the runs that time the end-to-end
metrics; under the profiler each span is also a ``record_function`` scope
named ``bench:<name>``, so the trace shows it."""

import contextlib
import time

import torch


class Spans:
    def __init__(self, sync, on=False):
        self.sync = sync
        self.on = on
        self.requests = []      # one {name: seconds} per request
        self.current = None

    def start_request(self):
        self.current = {}
        self.requests.append(self.current)

    @contextlib.contextmanager
    def __call__(self, name):
        if not self.on:
            yield
            return
        with torch.profiler.record_function(f"bench:{name}"):
            t0 = time.perf_counter()
            yield
            self.sync()
            dt = time.perf_counter() - t0
        self.current[name] = self.current.get(name, 0.0) + dt

    def mean_ms(self, name, skip=()):
        vals = [r[name] for i, r in enumerate(self.requests)
                if i not in skip and name in r]
        return 1e3 * sum(vals) / len(vals) if vals else None
