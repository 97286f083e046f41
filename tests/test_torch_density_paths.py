"""The port's default density paths against the JAX package, in f64 on the
CPU: L-BFGS iterations, the host-loop L-BFGS and TPGD optimizers (same
outer-step counts, same energies), the whole-optimization L-BFGS loop under
every stopping rule, the convergence diagnostics, and the PROFESS-4 golden
energy through the default ``optimize_density()``.

The system is the bench configuration (4-atom cubic fcc Al, WT + PBE) at
12^3.  JAX returns no step count from its host loop, so its compiled outer
step is wrapped to count the calls."""

import functools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from professad_tpu import system as jsys
from professad_tpu.ops import solvers as jsolvers
from professad_tpu.models import (IonIon as jIonIon,
                                  IonElectron as jIonElectron,
                                  Hartree as jHartree,
                                  WangTeter as jWangTeter,
                                  PerdewBurkeErnzerhof as jPBE)
from professad_tpu_torch import System
from professad_tpu_torch.ops import solvers
from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                        WangTeter, PerdewBurkeErnzerhof)
from paths import pot

SHAPE = (12, 12, 12)
FRAC = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0],
                 [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]])
J_TERMS = [jIonIon, jIonElectron, jHartree, jWangTeter, jPBE]
T_TERMS = [IonIon, IonElectron, Hartree, WangTeter, PerdewBurkeErnzerhof]
GOLDEN_EV = -57.183329401794985


def _port():
    return System(4.05 * np.eye(3), SHAPE, [["Al", pot("al.gga.recpot"),
                                             FRAC]], T_TERMS, units="a",
                  coord_type="fractional", device="cpu")


@pytest.fixture(scope="module")
def jax_system():
    return jsys.System(jnp.asarray(4.05 * np.eye(3)), SHAPE,
                       [["Al", pot("al.gga.recpot"), jnp.asarray(FRAC)]],
                       J_TERMS, units="a", coord_type="fractional")


def _jax_host_run(js, **kwargs):
    """(outer steps, energy in eV) of the JAX host loop from the uniform
    density."""
    name = ("_jit_lbfgs_outer" if kwargs.get("n_method", "LBFGS") == "LBFGS"
            else "_jit_tpgd_outer")
    outer, calls = getattr(js, name), []

    def counted(*args):
        calls.append(1)
        return outer(*args)

    setattr(js, name, counted)
    try:
        js.initialize_density()
        js.optimize_density(from_uniform=True, **kwargs)
    finally:
        setattr(js, name, outer)
    return len(calls), js.energy("eV")


@functools.lru_cache(maxsize=None)
def _port_run(**kwargs):
    """(outer steps, converged, energy in eV, system) of one port run from
    the uniform density, shared between the tests."""
    ts = _port()
    n_it, conv = ts.optimize_density(**kwargs)
    return n_it, conv, ts.energy("eV"), ts


def test_lbfgs_iterations_match_jax(jax_system):
    """Twelve L-BFGS iterations (two host-loop outer steps, so the ring
    buffers fill) from the same non-uniform chi0: x and f at rtol 1e-10."""
    js = jax_system
    ts = _port()
    # the JAX system's own arguments, so its compiled outer step is the
    # one its host loop runs
    jargs = (js._box_vecs, js._v_ext, js._N_elec)
    box, vext = (torch.tensor(np.asarray(a)) for a in jargs[:2])
    N = float(js._N_elec)
    chi0 = np.sqrt(N / ts.volume("b3")) * (
        1.0 + 0.05 * np.random.default_rng(7).random(SHAPE))
    st_j = jsolvers.lbfgs_init(lambda x: js._vg_chi(x, *jargs, None),
                               jnp.asarray(chi0))
    vg = lambda x: ts._chi_value_and_grad(x, box, vext, N)
    st = solvers.lbfgs_init(vg, torch.tensor(chi0))
    for _ in range(2):
        st_j = js._jit_lbfgs_outer(st_j, *jargs, 0.1, None)
        st = solvers.lbfgs_iterations(vg, st, 6, 0.1)
    assert st.n_iter == int(st_j.n_iter) == 12
    assert abs(float(st.f) - float(st_j.f)) <= 1e-10 * abs(float(st_j.f))
    x_ref = np.asarray(st_j.x)
    assert np.max(np.abs(st.x.numpy() - x_ref)) <= 1e-10 * np.max(
        np.abs(x_ref))
    assert np.allclose(st.rho.numpy(), np.asarray(st_j.rho), rtol=1e-8)


@pytest.mark.parametrize("n_method", ["LBFGS", "TPGD"])
def test_host_loop_matches_jax(jax_system, n_method):
    """The default host loop (6 L-BFGS iterations per outer step, or one
    BB1 TPGD step; checked from the 6th outer step on): the same number of
    outer steps and the same energy within 1e-9 eV."""
    n_ref, E_ref = _jax_host_run(jax_system, ntol=1e-7, n_method=n_method)
    n_it, conv, E, _ = _port_run(ntol=1e-7, n_method=n_method,
                                 from_uniform=True)
    assert conv and n_it == n_ref
    assert abs(E - E_ref) < 1e-9


@pytest.mark.parametrize("conv_target,ntol", [
    ("dE", 1e-7), ("dEdchi", 1e-4), ("euler", 1e-4)])
def test_jit_loop_matches_host_loop(conv_target, ntol):
    """The whole-optimization L-BFGS loop lands on the host loop's energy
    under every stopping rule (tests/test_den_opt.py's check)."""
    n_h, conv_h, E_h, _ = _port_run(ntol=ntol, conv_target=conv_target,
                                    from_uniform=True)
    n_j, conv_j, E_j, _ = _port_run(ntol=ntol, conv_target=conv_target,
                                    from_uniform=True, jit_loop=True)
    assert conv_h and conv_j
    assert abs(E_h - E_j) < 1e-6


@pytest.mark.parametrize("kwargs", [
    dict(n_method="LBFGS", n_step_size=1.0, precondition=True, ntol=1e-7),
    dict(n_method="TPGD", n_step_size=1.0, precondition=True, skip_iters=2,
         jit_loop=True, analytic=False, ntol=1e-8),
    dict(n_method="TPGD", jit_loop=True, analytic=False, ntol=1e-8),
], ids=["lbfgs-host-preconditioned", "tpgd-autograd-preconditioned",
        "tpgd-autograd"])
def test_other_paths_match_host_loop(kwargs):
    """The preconditioned host-loop L-BFGS, and the whole-optimization
    TPGD with the autograd gradient, with and without the exact
    preconditioner, land on the default path's energy."""
    n_it, conv, E, _ = _port_run(from_uniform=True, **kwargs)
    _, _, E_h, _ = _port_run(ntol=1e-7, n_method="LBFGS", from_uniform=True)
    assert conv and abs(E - E_h) < 1e-6


def test_bad_options_raise():
    ts = _port()
    with pytest.raises(ValueError, match="n_method"):
        ts.optimize_density(n_method="RPROP")
    with pytest.raises(ValueError, match="conv_target"):
        ts.optimize_density(jit_loop=True, conv_target="bogus")


def test_diagnostics_match_jax(jax_system):
    """functional_derivative in both modes, check_density_convergence in
    both modes and chemical_potential on the same non-uniform density,
    rtol 1e-10."""
    js = jax_system
    ts = _port()
    den = 1.0 + 0.2 * np.random.default_rng(11).random(SHAPE)
    den *= ts._N_elec / (den.mean() * ts.volume("b3"))
    js.set_density(jnp.asarray(den))
    ts._den = torch.tensor(den)
    for kind in ("density", "chi"):
        ref = np.asarray(js.functional_derivative(kind))
        out = ts.functional_derivative(kind).numpy()
        assert np.max(np.abs(out - ref)) <= 1e-10 * np.max(np.abs(ref))
    for method in ("dEdchi", "euler"):
        ref = js.check_density_convergence(method)
        assert abs(ts.check_density_convergence(method) - ref) \
            <= 1e-10 * abs(ref)
    ref = js.chemical_potential()
    assert abs(ts.chemical_potential() - ref) <= 1e-10 * abs(ref)
    with pytest.raises(ValueError):
        ts.functional_derivative("bogus")


def test_convergence_measures_consistent():
    """max |dE/dchi| equals the value rebuilt from dE/dn and the chain
    rule (tests/test_den_opt.py's identity), at the L-BFGS ground state."""
    _, _, _, ts = _port_run(ntol=1e-7, n_method="LBFGS", from_uniform=True)
    dEdn = ts.functional_derivative("density")
    den, vol, N = ts.density(), ts.volume(), ts.electron_count()
    chi = torch.sqrt(den)
    mu = torch.mean(dEdn * den) * vol / N
    rebuilt = (N / (torch.mean(chi ** 2) * vol)) * 2.0 * chi * (dEdn - mu)
    assert np.isclose(ts.check_density_convergence(),
                      float(rebuilt.abs().max()), rtol=1e-10)


def test_golden_energy_through_the_default_path():
    """Primitive fcc Al, WT + PBE, 18^3 (tests/test_match_profess4.py):
    the default optimize_density(), host-loop L-BFGS with the autograd
    gradient, reaches the PROFESS-4 energy."""
    cell = 4.050 * np.array([[0.5, 0.5, 0.0], [0.0, 0.5, 0.5],
                             [0.5, 0.0, 0.5]])
    s = System(cell, (18, 18, 18), [["Al", pot("al.gga.recpot"),
                                     np.zeros((1, 3))]], T_TERMS,
               units="a", coord_type="fractional", device="cpu")
    n_it, conv = s.optimize_density(ntol=1e-7)
    assert conv and n_it == 21
    assert abs(s.energy("eV") - GOLDEN_EV) < 1e-4


@pytest.mark.parametrize("term", ["WangTeter", "PerdewBurkeErnzerhof"])
def test_get_functional_derivative_matches_jax(term):
    """ops.autodiff.get_functional_derivative against the JAX function on
    the same density, rtol 1e-10."""
    from professad_tpu.ops.autodiff import get_functional_derivative as jgfd
    from professad_tpu_torch.ops.autodiff import get_functional_derivative
    import professad_tpu.models as jm
    import professad_tpu_torch.models as tm
    box = 4.05 / 0.529177210903 * np.eye(3)
    den = 0.02 * (1.0 + 0.3 * np.random.default_rng(3).random(SHAPE))
    ref = np.asarray(jgfd(jnp.asarray(box), jnp.asarray(den),
                          getattr(jm, term)))
    out = get_functional_derivative(torch.tensor(box), torch.tensor(den),
                                    getattr(tm, term)).numpy()
    assert np.max(np.abs(out - ref)) <= 1e-10 * np.max(np.abs(ref))
