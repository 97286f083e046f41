"""The port's second derivatives through the ground state and its EOS scan
on gloo ranks (P = 2 and 4), against the serial port.

Pressure, enthalpy, bulk modulus, elastic constants and force constants
of Li2 at 8^3 (the local term set, and K also with WT + PBE) run their
Hessian solves SPMD on the ranks' slabs (``ops.implicit`` with
``group=``), held to the serial getters at 1e-10 relative.  The JAX
package's own mesh getters are too slow to compile here
(``tests/test_parallel_implicit.py:29`` marks them heavy) and the serial
getters are held against JAX in the single-device tests.  ``eos_fit`` on a
"grid" mesh (each volume solved on the pencils) and on a "batch" mesh (the
volumes split over the ranks) against the serial scans: 2e-4 relative on
the fit (``tests/test_parallel_implicit.py``'s bound; the four-parameter
fit amplifies the per-volume energies' rounding).
"""

import numpy as np
import pytest

import torch_parallel_cases as C
from torch_ranks import start_ranks

RANKS = (2, 4)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    return {p: start_ranks(C.implicit_cases, p,
                           tmp_path_factory.mktemp(f"p{p}"))
            for p in RANKS}


@pytest.fixture(scope="module")
def ref(groups):
    """The serial getters and scans, computed while the groups run."""
    s = C.implicit_state()
    r = dict(P=s.pressure(), H=s.enthalpy(), K=s.bulk_modulus(),
             C=s.elastic_constants().numpy(),
             Phi=s.force_constants([0]).numpy(),
             K_wt_pbe=C.implicit_state(C.WT_PBE).bulk_modulus(),
             eos_grid=np.asarray(C.fcc_al().eos_fit(**C.EOS)[0]),
             eos_batch=np.asarray(C.fcc_al().eos_fit(batched=True,
                                                     **C.EOS)[0]))
    return r


@pytest.mark.parametrize("p", RANKS)
@pytest.mark.parametrize("name", ["P", "H", "K", "K_wt_pbe"])
def test_mesh_scalar_getters(groups, ref, p, name):
    got = groups[p].result()[name]
    assert abs(got - ref[name]) <= 1e-10 * abs(ref[name]), (got, ref[name])


@pytest.mark.parametrize("p", RANKS)
@pytest.mark.parametrize("name", ["C", "Phi"])
def test_mesh_tensor_getters(groups, ref, p, name):
    got, want = groups[p].result()[name], ref[name]
    assert np.max(np.abs(got - want)) <= 1e-10 * np.max(np.abs(want))


@pytest.mark.parametrize("p", RANKS)
@pytest.mark.parametrize("layout", ["eos_grid", "eos_batch"])
def test_mesh_eos_fit(groups, ref, p, layout):
    got, want = groups[p].result()[layout], ref[layout]
    assert np.max(np.abs(got - want) / np.abs(want)) < 2e-4, (got, want)
