"""Gloo ranks on the CPU for the port's multi-device tests.

``start_ranks(cases, nprocs, tmp)`` starts one ``torch.distributed`` gloo
group of ``nprocs`` processes (the ``spawn`` start method: the parent test
process has JAX and its threads loaded, and the workers import no JAX),
meeting at a ``file://`` rendezvous under ``tmp`` (no TCP port, so test
files can run side by side).  Every rank calls ``cases(mesh)`` (a module-
level function of a module that imports no JAX) with a ("batch", "grid")
mesh over all ranks; rank 0's returned dict of numpy arrays and numbers is
sent back to the parent by ``.result()``.  One group serves all of a test
file's cases, and the groups run while the parent computes its references.
``result()`` waits at most ``RANK_DEADLINE_S`` seconds from the start:
then it terminates the ranks still alive and raises, naming them, and
raises the same error on every later call.
"""

import os
import pickle
import sys
import time
import traceback

import torch.multiprocessing as mp

RANK_DEADLINE_S = 240
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _worker(rank, nprocs, rdv, module, name, out_dir):
    sys.path[:0] = [REPO, os.path.dirname(os.path.abspath(__file__))]
    import importlib
    import torch
    import torch.distributed as dist
    from professad_tpu_torch.parallel import init_process_group, make_mesh
    torch.set_num_threads(1)
    init_process_group(rank, nprocs, "file://" + rdv, device="cpu",
                       timeout=120)
    try:
        res = getattr(importlib.import_module(module), name)(make_mesh())
        err = None
    except Exception:
        res, err = None, traceback.format_exc()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump((res, err), fh)
    dist.destroy_process_group()


class start_ranks:
    """Start ``cases`` on ``nprocs`` gloo ranks without waiting;
    ``result()`` joins them and returns rank 0's dict.  A rank that raised
    fails ``result()`` with that rank's traceback; ranks still alive
    ``RANK_DEADLINE_S`` seconds after the start are terminated and fail
    it."""

    def __init__(self, cases, nprocs, tmp):
        self.nprocs, self.tmp = nprocs, str(tmp)
        self._end = time.monotonic() + RANK_DEADLINE_S
        self._ctx = mp.start_processes(
            _worker, args=(nprocs, os.path.join(self.tmp, "rdv"),
                           cases.__module__, cases.__name__, self.tmp),
            nprocs=nprocs, start_method="spawn", join=False)
        self._out = self._timeout = None

    def result(self):
        if self._timeout is not None:
            raise self._timeout
        if self._out is None:
            while not self._ctx.join(
                    timeout=max(self._end - time.monotonic(), 0)):
                if time.monotonic() >= self._end:
                    self._stop()
            out = {}
            for r in range(self.nprocs):
                with open(os.path.join(self.tmp, f"rank{r}.pkl"), "rb") as fh:
                    out[r] = pickle.load(fh)
            for r, (_, err) in out.items():
                if err is not None:
                    raise AssertionError(
                        f"rank {r} of {self.nprocs} failed:\n{err}")
            self._out = out[0][0]
        return self._out

    def _stop(self):
        procs = self._ctx.processes
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        for r in alive:
            procs[r].terminate()
            procs[r].join(5)
            if procs[r].is_alive():
                procs[r].kill()
                procs[r].join()
        self._timeout = TimeoutError(
            f"ranks {alive} of {self.nprocs} still running "
            f"{RANK_DEADLINE_S} s after the start; terminated")
        raise self._timeout
