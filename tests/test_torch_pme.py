"""The port's particle-mesh Ewald structure factor against the JAX
package, in f64 on the CPU: the B-spline values, the deconvolution
factors and the structure factor at 1e-12 on (35, 36, 37) and the skewed
cell of ``tests/test_particle_mesh_ewald.py::test3``; every ``method``
runs the same scatter; the order check; and ``System(pme_order=20)``
v_ext, energy, forces and stress against the JAX package's PME System on
one state at 1e-10, its energy against the port's exact path."""

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
from professad_tpu.models import ions as jions
from professad_tpu_torch import System, system_state_from_jax
from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                        WangTeter, PerdewBurkeErnzerhof)
from professad_tpu_torch.models import ions
from paths import pot

SKEWED = np.array([[4.9, 0.1, 0.2], [-0.2, 5.0, 0.3], [0.3, -0.1, 5.1]])
CART = np.array([[0.0, 0.0, 0.0], [2.0, 0.1, 0.2], [0.3, 1.0, 2.0]])


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return np.max(np.abs(a - ref)) / np.max(np.abs(ref))


@pytest.mark.parametrize("order", [2, 3, 8, 20])
def test_b_spline_values_and_factors_match_jax(order):
    x = np.random.default_rng(order).random(17)
    assert _rel(ions.cardinal_b_spline_values(_t(x), order).numpy(),
                jions.cardinal_b_spline_values(jnp.asarray(x), order)) \
        <= 1e-12
    m = np.arange(9.0)
    assert _rel(ions.exponential_spline_b(_t(m), 9, order).numpy(),
                jions.exponential_spline_b(jnp.asarray(m), 9, order)) <= 1e-12


@pytest.mark.parametrize("order", [4, 20])
def test_structure_factor_spline_matches_jax(order):
    """1e-12 at order 4.  At order 20 the deconvolution amplifies the
    charge grid's rounding near the Nyquist corner: the JAX package's own
    eager and jitted results differ there (4.6e-7 relative), so the whole
    array is held to twice that spread and the low-k block, where PME is
    accurate (test3), to 1e-12."""
    shape = (35, 36, 37)
    S = ions.structure_factor_spline(_t(SKEWED), shape, _t(CART),
                                     order).numpy()
    args = (jnp.asarray(SKEWED), shape, jnp.asarray(CART), order)
    ref = np.asarray(jions.structure_factor_spline(*args))
    assert S.shape == ref.shape
    if order == 4:
        assert _rel(S, ref) <= 1e-12
        return
    jit = np.asarray(jax.jit(jions.structure_factor_spline,
                             static_argnums=(1, 3))(*args))
    assert _rel(S, ref) <= 2.0 * _rel(jit, ref)
    t = 10
    for sl in ((slice(0, t), slice(0, t)), (slice(0, t), slice(-t, None)),
               (slice(-t, None), slice(0, t)),
               (slice(-t, None), slice(-t, None))):
        low = sl + (slice(0, t),)
        assert _rel(S[low], ref[low]) <= 1e-12
    exact = ions.structure_factor(_t(SKEWED), shape, _t(CART)).numpy()
    assert np.allclose(exact[:t, :t, :t], S[:t, :t, :t])


def test_methods_and_rejections():
    rng = np.random.default_rng(7)
    box = _t(7.0 * np.eye(3) + 0.3 * rng.random((3, 3)))
    coords = _t(rng.random((41, 3))) @ box
    shape = (18, 20, 14)
    S = ions.structure_factor_spline(box, shape, coords, 10, "scatter")
    for method in ("mxu", "auto"):
        assert torch.equal(
            ions.structure_factor_spline(box, shape, coords, 10, method), S)
    with pytest.raises(ValueError):
        ions.structure_factor_spline(box, shape, coords, 10, "dense")
    f = torch.ones((18, 20, 8), dtype=torch.float64)
    for order in (3, 0):
        with pytest.raises(ValueError, match="even order"):
            ions.lattice_sum(box, shape, coords, f, order)
    with pytest.raises(ValueError):
        ions.cardinal_b_spline_values(_t([0.5]), 1)


SHAPE = (15, 15, 15)
LI = 6.96 * np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]])


def _port(pme_order):
    return System(6.96 * np.eye(3), SHAPE, [["Li", pot("li.gga.recpot"), LI]],
                  [IonIon, IonElectron, Hartree, WangTeter,
                   PerdewBurkeErnzerhof], units="b", coord_type="fractional",
                  pme_order=pme_order, device="cpu")


def test_pme_system_matches_exact_and_jax():
    """The Li cell of test_particle_mesh_ewald.py::test4 on a 15^3 grid:
    the JAX PME System's converged state carried into the port's PME and
    exact Systems; the port's PME v_ext, energy, forces and stress against
    JAX's at 1e-10, and its energy against the exact path at the
    np.allclose bounds of test4."""
    js = jsys.System(jnp.asarray(6.96 * np.eye(3)), SHAPE,
                     [["Li", pot("li.gga.recpot"), jnp.asarray(LI)]],
                     [jIonIon, jIonElectron, jHartree, jWangTeter, jPBE],
                     units="b", coord_type="fractional", pme_order=20)
    js.optimize_density(ntol=1e-9)
    state = system_state_from_jax(js.state_dict(), device="cpu")
    pme, exact = _port(20), _port(None)
    assert _rel(pme.ionic_potential().numpy(), js.ionic_potential()) <= 1e-10
    for s in (pme, exact):
        s.set_density(state["den"])
    assert abs(pme.energy() - js.energy()) <= 1e-10 * abs(js.energy())
    assert _rel(pme.forces().numpy(), jax.jit(js.forces)()) <= 1e-10
    assert _rel(pme.stress().numpy(), js.stress()) <= 1e-10
    # on this coarse grid order-20 PME matches the exact path in the
    # energy at test4's bounds; forces and stress are held against the
    # exact path at test4's bounds at 128^3 on the card (chip_smoke.py)
    assert np.allclose(pme.energy("eV"), exact.energy("eV"))
