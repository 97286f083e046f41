"""The port's pressure, enthalpy and second derivatives through the ground
state against the JAX package, in f64 on the CPU (the JAX getters
themselves, whose first calls compile for minutes, are held in
``test_torch_implicit_getters.py``, marked slow).

One state: bcc Li (2 atoms, ion 1 displaced so that no symmetry hides an
error) at 6^3, its density converged by the JAX package and carried
across with ``system_state_from_jax``.  Pressure, enthalpy, bulk modulus,
elastic constants and force constants are held against a dense
implicit-function-theorem reference built here from the JAX package's own
energy closure E(chi, h, R): its full Hessian by a jitted Hessian-vector
product on every unit vector, the chi block projected off chi^ and
pseudo-inverted by ``lstsq``, so d2Ebar = E_tt - b^T H^+ b for
theta = (h, R); the volume and the strains with the ions following the
cell enter by the chain rule.  The port computes the same closed form with
CG solves, so the bound is rtol 1e-8 (1e-10 for the first derivatives).
Then the CG residual warning and the getters' units."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from professad_tpu import system as jsys
from professad_tpu.models import (IonIon as jIonIon,
                                  IonElectron as jIonElectron,
                                  Hartree as jHartree,
                                  WangTeter as jWangTeter,
                                  PerdewBurkeErnzerhof as jPBE)
from professad_tpu.ops.grid import wmean as jwmean, volume as jvolume
from professad_tpu_torch import System, system_state_from_jax
from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                        WangTeter, PerdewBurkeErnzerhof)
from professad_tpu_torch.ops import implicit
from professad_tpu_torch.utils.constants import (A_PER_B, EV_PER_HA,
                                                 GPA_PER_ATOMIC)
from paths import pot

SHAPE = (6, 6, 6)
BOX = 3.48 * np.eye(3)
FRAC = np.array([[0.0, 0.0, 0.0], [0.53, 0.48, 0.51]])
RC = 12.0   # bohr: a short ion-ion cutoff keeps the image table small


@pytest.fixture(scope="module")
def pair():
    js = jsys.System(jnp.asarray(BOX), SHAPE,
                     [["Li", pot("li.gga.recpot"), jnp.asarray(FRAC)]],
                     [jIonIon, jIonElectron, jHartree, jWangTeter, jPBE],
                     units="a", coord_type="fractional", Rc=RC)
    js.optimize_density(ntol=1e-10)
    ts = System(BOX, SHAPE, [["Li", pot("li.gga.recpot"), FRAC]],
                [IonIon, IonElectron, Hartree, WangTeter,
                 PerdewBurkeErnzerhof], units="a", coord_type="fractional",
                Rc=RC, device="cpu")
    ts.load_state_dict(system_state_from_jax(js.state_dict(), device="cpu"))
    return js, ts


@pytest.fixture(scope="module")
def dense(pair):
    """The dense implicit-function-theorem reference from the JAX
    package's energy E(chi, h, R) (the closures of its elastic and force
    constants with the ion positions R free): one jitted jvp of the
    gradient gives (dE/dz, H v) on every unit vector of z = (chi, h, R).
    Returns (dE/dtheta at fixed chi, d2Ebar/dtheta2) for theta = (h, R),
    Ebar(theta) = E(chi*(theta), theta), with H^+ the pseudo-inverse of the
    chi block projected off chi^ (``lstsq``)."""
    js, _ = pair
    N = js._N_elec
    chi = jnp.sqrt(js._den)
    n = chi.size
    theta = jnp.concatenate([js._box_vecs.ravel(),
                             (js._frac_ion_coords @ js._box_vecs).ravel()])
    z0 = jnp.concatenate([chi.ravel(), theta])

    def energy(z):
        c, h = z[:n].reshape(chi.shape), z[n:n + 9].reshape(3, 3)
        cart = z[n + 9:].reshape(-1, 3)
        den = (N / (jwmean(c * c) * jvolume(h))) * c * c
        return (js._density_terms_energy(h, den,
                                         js._potential_from_ions(h, cart))
                + js._ion_ion_interaction(h, cart))
    jvp = jax.jit(lambda v: jax.jvp(jax.grad(energy), (z0,), (v,)))
    cols = [jvp(e) for e in jnp.eye(z0.size)]
    G = np.asarray(cols[0][0])[n:]
    Hz = np.stack([np.asarray(c[1]) for c in cols])
    H, B, Ett = Hz[:n, :n], Hz[:n, n:], Hz[n:, n:]
    ch = np.asarray(chi).ravel() / np.linalg.norm(np.asarray(chi))
    P = np.eye(n) - np.outer(ch, ch)
    U = np.linalg.lstsq(P @ H @ P, P @ B, rcond=None)[0]
    return G, Ett - (P @ B).T @ U


def _with_ions(frac, dh):
    """(dh, d cart) for a change dh of the cell with the ions following
    it (cart = frac h), flattened as theta."""
    return np.concatenate([dh.ravel(), (frac @ dh).ravel()])


def _rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return np.max(np.abs(a - ref)) / np.max(np.abs(ref))


def test_pressure_and_enthalpy_match_jax(pair, dense):
    """P = -dE/dV at the JAX state: -G t' of the JAX energy's gradient
    (the JAX getters' own values, by its eager calls, are held in
    ``test_torch_implicit_getters.py``), and H = E + P V."""
    js, ts = pair
    G, _ = dense
    h0, V0 = np.asarray(js._box_vecs), js.volume("b3")
    P_ref = -G @ _with_ions(np.asarray(js._frac_ion_coords), h0 / (3 * V0))
    P = ts.pressure()
    assert abs(P - P_ref) <= 1e-10 * abs(P_ref)
    assert ts.pressure("GPa") == pytest.approx(P * GPA_PER_ATOMIC, rel=1e-14)
    H_ref = js.energy() + P_ref * V0
    assert abs(ts.enthalpy() - H_ref) <= 1e-10 * abs(H_ref)
    assert ts.enthalpy("eV") == pytest.approx(ts.enthalpy() * EV_PER_HA,
                                              rel=1e-14)


def test_bulk_modulus_matches_dense_ift(pair, dense):
    """K = V d2Ebar/dV2 along h(V) = h0 (V/V0)^(1/3), ions following:
    t' H t + G t'' by the chain rule (t = (h, R) as a function of V)."""
    js, ts = pair
    implicit.solves.clear()
    K = ts.bulk_modulus()
    assert len(implicit.solves) == 1
    iters, rel = implicit.solves[0]
    assert 0 < iters < 2000 and rel < 1e-6
    G, Hbar = dense
    h0, V0 = np.asarray(js._box_vecs), js.volume("b3")
    frac = np.asarray(js._frac_ion_coords)
    t1 = _with_ions(frac, h0 / (3.0 * V0))
    t2 = _with_ions(frac, -2.0 * h0 / (9.0 * V0 ** 2))
    K_ref = V0 * (t1 @ Hbar @ t1 + G @ t2)
    assert abs(K - K_ref) <= 1e-8 * abs(K_ref)
    assert ts.bulk_modulus("GPa") == pytest.approx(K * GPA_PER_ATOMIC,
                                                   rel=1e-10)


def test_elastic_constants_match_dense_ift(pair, dense):
    js, ts = pair
    implicit.solves.clear()
    C = ts.elastic_constants()
    assert len(implicit.solves) == 9
    assert C.shape == (6, 6) and torch.equal(C, C.T)
    G, Hbar = dense
    h0 = np.asarray(js._box_vecs)
    J = np.stack([_with_ions(np.asarray(js._frac_ion_coords), e.reshape(3, 3))
                  for e in np.eye(9)], axis=1)      # d theta / d h
    Gh, Hh = J.T @ G, J.T @ Hbar @ J

    def stress_of_h(h):
        Gl = Gh.reshape(3, 3) + (Hh @ (h - h0).reshape(-1)).reshape(3, 3)
        return Gl.T @ h / jnp.linalg.det(h)
    D = np.asarray(jax.jacfwd(stress_of_h)(jnp.asarray(h0)))
    voigt = [(0, 0), (1, 1), (2, 2), (1, 2), (0, 2), (0, 1)]
    Cref = np.zeros((6, 6))
    for a, (i, j) in enumerate(voigt):
        M = D[i, j].T @ h0
        M = 0.5 * (M + M.T)
        for b, (k, l) in enumerate(voigt):
            Cref[a, b] = M[k, l]
    Cref = np.triu(Cref) + np.triu(Cref, 1).T
    assert _rel(C.numpy(), Cref) <= 1e-8
    # the stress at fixed density is the first derivative in the cell
    sigma = Gh.reshape(3, 3).T @ h0 / np.linalg.det(h0)
    assert _rel(ts.stress().numpy(), 0.5 * (sigma + sigma.T)) <= 1e-10


def test_force_constants_match_dense_ift(pair, dense):
    _, ts = pair
    implicit.solves.clear()
    FC = ts.force_constants([1], units="Ha/b2")
    assert FC.shape == (1, 2, 3, 3) and len(implicit.solves) == 3
    _, Hbar = dense
    ref = Hbar[9:, 9:].reshape(2, 3, 2, 3)[1].transpose(1, 0, 2)  # (j, i, b)
    assert _rel(FC[0].numpy(), ref) <= 1e-8
    assert torch.allclose(ts.force_constants([1]),
                          FC * EV_PER_HA / A_PER_B**2, rtol=1e-14, atol=0)
    with pytest.raises(ValueError):
        ts.force_constants([1], units="Ha")


def test_cg_residual_warning(pair, capfd):
    """A solve stopped after 2 iterations warns on stderr."""
    _, ts = pair
    energy = ts._volume_energy_fn()
    vol0 = torch.tensor(ts.volume("b3"), dtype=torch.float64)
    implicit.solves.clear()
    implicit.ground_state_hessian(energy, ts._gs_chi(), vol0, cg_maxiter=2)
    assert implicit.solves[0][0] == 2 and implicit.solves[0][1] > 1e-6
    assert "CG Hessian solve stagnated" in capfd.readouterr().err
