"""The port's forces and stress against the JAX package, in f64 on the CPU:
both on the same state carried across with ``system_state_from_jax`` (the
4-atom fcc Al cell with one ion displaced and a seeded non-uniform
density), the forces against central finite differences of the
re-optimized energy, their units, and the state they leave behind."""

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
from professad_tpu_torch import System, system_state_from_jax
from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                        WangTeter, PerdewBurkeErnzerhof)
from professad_tpu_torch.utils.constants import (A_PER_B, EV_PER_HA,
                                                 GPA_PER_ATOMIC)
from paths import pot

SHAPE = (12, 12, 12)
FRAC = np.array([[0.0, 0.0, 0.0], [0.52, 0.49, 0.03],
                 [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]])
EPS = 1e-4  # Angstrom, the finite-difference step


def _port():
    return System(4.05 * np.eye(3), SHAPE,
                  [["Al", pot("al.gga.recpot"), FRAC]],
                  [IonIon, IonElectron, Hartree, WangTeter,
                   PerdewBurkeErnzerhof], units="a", coord_type="fractional",
                  device="cpu")


@pytest.fixture(scope="module")
def pair():
    js = jsys.System(jnp.asarray(4.05 * np.eye(3)), SHAPE,
                     [["Al", pot("al.gga.recpot"), jnp.asarray(FRAC)]],
                     [jIonIon, jIonElectron, jHartree, jWangTeter, jPBE],
                     units="a", coord_type="fractional")
    den = 1.0 + 0.2 * np.random.default_rng(5).random(SHAPE)
    den *= js._N_elec / (den.mean() * js.volume("b3"))
    js.set_density(jnp.asarray(den))
    ts = _port()
    ts.load_state_dict(system_state_from_jax(js.state_dict(), device="cpu"))
    return js, ts


def _close(a, ref, rtol=1e-10):
    ref = np.asarray(ref)
    return np.max(np.abs(a - ref)) <= rtol * np.max(np.abs(ref))


def test_forces_match_jax(pair):
    js, ts = pair
    F = ts.forces()
    assert F.shape == (4, 3) and F.dtype == torch.float64
    # jit compiles the JAX reference once instead of dispatching op by op
    assert _close(F.numpy(), jax.jit(js.forces)())


def test_stress_matches_jax(pair):
    js, ts = pair
    sigma = ts.stress()
    assert sigma.shape == (3, 3)
    assert torch.equal(sigma, sigma.T)
    assert _close(sigma.numpy(), js.stress())


def test_units(pair):
    _, ts = pair
    F = ts.forces()
    assert torch.allclose(ts.forces("eV/a"), F * EV_PER_HA / A_PER_B,
                          rtol=1e-14, atol=0)
    sigma = ts.stress()
    assert torch.allclose(ts.stress("eV/a3"), sigma * EV_PER_HA / A_PER_B**3,
                          rtol=1e-14, atol=0)
    assert torch.allclose(ts.stress("GPa"), sigma * GPA_PER_ATOMIC,
                          rtol=1e-14, atol=0)
    with pytest.raises(ValueError):
        ts.forces("N")
    with pytest.raises(ValueError):
        ts.stress("bar")


def test_derivatives_leave_the_state_unchanged(pair):
    """Forces and stress differentiate through the ion-ion sum, which must
    not overwrite the cached ion-ion energy or the stored energy."""
    _, ts = pair
    E, cache, den = ts.energy(), ts._Eion_cache, ts.density().clone()
    ts.forces()
    ts.stress()
    assert ts.energy() == E and ts._Eion_cache == cache
    assert torch.equal(ts.density(), den)


def test_forces_match_finite_differences():
    """Hellmann-Feynman forces of the displaced ion against central
    differences of the energy, re-optimized through the default
    optimize_density() at each displacement (tests/test_forces.py's
    check)."""
    ts = _port()
    ts.optimize_density(ntol=1e-8)
    R0 = ts.cartesian_ionic_coordinates("a").numpy()
    F = ts.forces("eV/a").numpy()[1]
    F_fd = np.zeros(3)
    for axis in range(3):
        E = []
        for sign in (1.0, -1.0):
            R = R0.copy()
            R[1, axis] += sign * EPS
            ts.place_ions(R, units="a")
            ts.optimize_density(ntol=1e-8)
            E.append(ts.energy("eV"))
        F_fd[axis] = -(E[0] - E[1]) / (2 * EPS)
    assert np.allclose(F, F_fd, atol=1e-4), np.abs(F - F_fd).max()
