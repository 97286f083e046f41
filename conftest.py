"""Test-suite settings that sit above ``tests/conftest.py``.

Pytest loads this file first, so the XLA flag below is in ``XLA_FLAGS``
before ``tests/conftest.py`` adds its device count and imports JAX.

Under xdist (one worker per core) every worker holds torch to one intra-op
thread and XLA:CPU to one Eigen thread: each worker's default pools
spinning beside the others' made the port's solves 3-15x slower and the
JAX package's files up to 1.6x slower.  A run in one process keeps the
default pools.

``SLOW`` names the JAX package's own tests that take minutes to tens of
minutes each: they are marked ``slow``, which leaves them out of tier-1
(``-m 'not slow'``); ``-m slow`` runs them.  They prove again the frozen
reference, which the port's parity tests hold the port against.

Every phase (setup, call, teardown) of a test under ``tests/`` that is not
marked ``slow`` runs under one time limit, ``TEST_LIMIT_S``: a SIGALRM
fails the phase, naming the limit, and a faulthandler dump ends the
process a minute later if the phase hangs in native code, where the signal
cannot be taken.  xdist runs the tests on each worker's main thread, which
is where the signal arrives.
"""

import faulthandler
import os
import pathlib
import signal

import pytest

if os.environ.get("PYTEST_XDIST_WORKER"):
    import torch
    torch.set_num_threads(1)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_cpu_multi_thread_eigen=false").strip()

TESTS = pathlib.Path(__file__).resolve().parent / "tests"
TEST_LIMIT_S = 300
SLOW = {
    "tests/test_parallel_implicit.py::test_mesh_pressure_enthalpy_parity",
    "tests/test_parallel_implicit.py::test_mesh_bulk_modulus_parity_smoke",
    "tests/test_smoke.py::test_distributed_pencil_solve_and_properties",
    "tests/test_smoke.py::test_implicit_second_derivative_surface",
    "tests/test_gs_training.py::test_gs_pressure_and_bulk_modulus_grads_vs_fd",
    "tests/test_second_derivatives.py::"
    "test_bulk_modulus_and_elastic_constants_vs_fd",
    "tests/test_docs_parity.py::test_fcc_al_elastic_constants_docs_numbers",
    "tests/test_docs_parity.py::test_al_polymorph_eos_table",
    "tests/test_system_utils.py::test_wrapped_term_name_dispatch_parity",
    "tests/test_f32_accuracy.py::test_f32_energy_and_stress_bounds_fcc_al",
}


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    # before the mark plugin's own hook deselects by ``-m``
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)


def _over_limit(signum, frame):
    pytest.fail(f"test phase exceeded the {TEST_LIMIT_S} s limit "
                "(conftest.py TEST_LIMIT_S)")


@pytest.hookimpl(wrapper=True)
def _limited(item):
    if item.get_closest_marker("slow") or TESTS not in item.path.parents:
        return (yield)
    old = signal.signal(signal.SIGALRM, _over_limit)
    signal.setitimer(signal.ITIMER_REAL, TEST_LIMIT_S)
    # a phase stuck in native code never takes the signal: end the process
    faulthandler.dump_traceback_later(TEST_LIMIT_S + 60, exit=True)
    try:
        return (yield)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, old)


pytest_runtest_setup = pytest_runtest_call = pytest_runtest_teardown = \
    _limited
