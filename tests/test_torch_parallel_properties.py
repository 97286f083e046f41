"""The port's distributed property surface on gloo ranks (P = 2 and 4):
forces and stress through the pencil layer (WT + PBE, a generic term set,
the PME structure factor from the slab spread), the mesh energy assembly
(with the HC kernel hoists on the k-pencils), a geometry relaxation and a
parameterized-geometry step on the mesh, against the serial port.

Bounds of ``tests/test_parallel_properties.py``: forces and stress within
1e-10 of the serial path relative to their largest entry, energies within
1e-12, the relaxation converged with its final forces equal to the serial
forces of the same state within 1e-9 eV/A, the parameterized step within
1e-9.  The serial path is itself held against the JAX package in the
single-device tests; its references for forces, stress and energy are
taken at the density each group reached.  One group per rank count runs
every case (``torch_parallel_cases.property_cases``) while the parent
computes the serial references.
"""

import numpy as np
import pytest
import torch

import torch_parallel_cases as C
from torch_ranks import start_ranks

RANKS = (2, 4)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    return {p: start_ranks(C.property_cases, p,
                           tmp_path_factory.mktemp(f"p{p}"))
            for p in RANKS}


@pytest.fixture(scope="module")
def serial(groups):
    """The serial references, computed while the groups run; those at a
    group's density by ``at_density``."""
    r = {"hc_E": float(C.hc_system()._compute_energy())}
    s = C.li2(C.RELAX_SHAPE)
    _, p = s.optimize_parameterized_geometry(
        torch.tensor([C.LI_LEN], dtype=torch.float64), C.geometry,
        **C.GEOM_STEP)
    r["param_p"] = p.numpy()
    return r


def at_density(den):
    """Serial forces, stress and energy at the density a group reached
    (the derivatives are held at any density)."""
    den = torch.tensor(den)
    r = {}
    s = C.li2()
    s.set_density(den)
    r["F"], r["sigma"] = s.forces().numpy(), s.stress().numpy()
    r["E"] = float(s._compute_energy())
    s = C.li2(terms=C.GENERIC)
    s.set_density(den)
    r["generic_sigma"] = s.stress().numpy()
    s = C.li2(pme_order=8)
    s.set_density(den)
    r["pme_F"], r["pme_sigma"] = s.forces().numpy(), s.stress().numpy()
    return r


@pytest.fixture(scope="module")
def ref(groups, serial):
    return {p: dict(serial, **at_density(groups[p].result()["den"]))
            for p in RANKS}


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("p", RANKS)
def test_forces_and_stress_mesh_parity(groups, ref, p):
    out, ref = groups[p].result(), ref[p]
    assert np.max(np.abs(ref["F"])) > 1e-4     # a displaced ion: real forces
    assert _rel(out["F"], ref["F"]) < 1e-10
    assert _rel(out["sigma"], ref["sigma"]) < 1e-10


@pytest.mark.parametrize("p", RANKS)
def test_stress_mesh_parity_generic_terms(groups, ref, p):
    out, ref = groups[p].result(), ref[p]
    assert _rel(out["generic_sigma"], ref["generic_sigma"]) < 1e-10


@pytest.mark.parametrize("p", RANKS)
def test_pme_forces_and_stress_mesh_parity(groups, ref, p):
    """The PME v_ext rebuilt on the slabs (masked slab spread, k-pencil
    deconvolution) and differentiated through them."""
    out, ref = groups[p].result(), ref[p]
    assert _rel(out["pme_F"], ref["pme_F"]) < 1e-10
    assert _rel(out["pme_sigma"], ref["pme_sigma"]) < 1e-10


@pytest.mark.parametrize("p", RANKS)
def test_energy_assembly_mesh_parity(groups, ref, p):
    out, ref = groups[p].result(), ref[p]
    assert abs(out["E_assembly"] - ref["E"]) <= 1e-12 * abs(ref["E"])
    # the HC kernel slabs hoisted by prepare() ride the mesh energy
    assert abs(out["hc_E"] - ref["hc_E"]) <= 1e-12 * abs(ref["hc_E"])


@pytest.mark.parametrize("p", RANKS)
def test_geometry_relaxation_mesh(groups, p):
    """optimize_geometry(mesh=...) relaxes the displaced Li2: converged,
    the mesh attached, and its final forces equal the serial forces of the
    same state."""
    got = groups[p].result()["relax"]
    assert got["ok"] and got["attached"]
    assert np.max(np.abs(got["F"])) < C.RELAX["ftol"]
    s = C.li2(C.RELAX_SHAPE, terms=C.LOCAL)
    s.place_ions(got["frac"], coord_type="fractional")
    s.set_density(torch.tensor(got["den"]))
    F = s.forces("eV/a").numpy()
    assert np.max(np.abs(got["F"] - F)) < 1e-9
    assert np.max(np.abs(F)) < C.RELAX["ftol"]


@pytest.mark.parametrize("p", RANKS)
def test_parameterized_geometry_mesh_step(groups, serial, p):
    """One fixed TPGD step p1 = p0 - lr dE/dp on a set_mesh-attached
    System: the distributed parameter gradient equals the serial one (a
    multi-step BB trajectory amplifies density-convergence noise, so one
    step is what is held, as in the JAX package's test)."""
    got = groups[p].result()["param_p"]
    assert np.max(np.abs(got - serial["param_p"])) < 1e-9
