"""Tracing and step-timing hooks.

PyTorch port of ``professad_tpu/utils/profiling.py``:

* ``trace(logdir)``: context manager around ``torch.profiler.profile``
  (host, and the CUDA devices when present) that writes a Chrome trace
  (``*.pt.trace.json``, also read by TensorBoard's profiler plugin) into
  ``logdir``;
* ``annotate(name)``: a ``torch.profiler.record_function`` scope, so that
  host phases (density optimization steps, geometry steps) show on the
  trace's timeline;
* ``StepTimer``: wall-clock step metrics that synchronise the CUDA devices
  of the tensors they are given before reading the clock.
"""

import contextlib
import time

import torch
from torch.utils._pytree import tree_leaves

__all__ = ["trace", "annotate", "StepTimer"]


@contextlib.contextmanager
def trace(logdir):
    """Profile everything in the block and write the trace to ``logdir``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(logdir))) as prof:
        yield prof


def annotate(name):
    """Named scope that appears on the profiler's timeline."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock step metrics with device synchronisation.

    >>> timer = StepTimer().start()
    >>> for _ in range(10):
    ...     state = step(state)
    ...     timer.tick(state)     # waits for the step's tensors
    >>> timer.summary()           # {'steps': 10, 'mean_s': ..., ...}
    """

    def __init__(self):
        self.times = []
        self._last = None

    def start(self):
        self._last = time.perf_counter()
        return self

    def tick(self, *sync_on):
        """Close a step: synchronise each CUDA device that holds a tensor
        among ``sync_on`` (nested lists, tuples and dicts are searched),
        then read the clock."""
        devices = {t.device for t in tree_leaves(sync_on)
                   if torch.is_tensor(t) and t.device.type == "cuda"}
        for dev in devices:
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
        self._last = now

    def summary(self):
        if not self.times:
            return {"steps": 0}
        n = len(self.times)
        total = sum(self.times)
        return {
            "steps": n,
            "total_s": total,
            "mean_s": total / n,
            "min_s": min(self.times),
            "max_s": max(self.times),
            "steps_per_s": n / total if total > 0 else float("inf"),
        }
