"""The port's System against the JAX package: ionic setup, the setters and
getters, state carried across (``state_dict``, ``save`` / ``load`` both
ways, ``set_density(resample=True)``), TPGD iterations, user-supplied
potentials, and the PROFESS-4 golden energy reached through the port's own
main path.  f64 on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from professad_tpu import system as jsys
from professad_tpu.ops import solvers as jsolvers
from professad_tpu.models import (IonIon as jIonIon,
                                  IonElectron as jIonElectron,
                                  Hartree as jHartree,
                                  WangTeter as jWangTeter,
                                  PerdewBurkeErnzerhof as jPBE)
from professad_tpu.ops.grid import spectral_resample as jresample
from professad_tpu.models import potentials as jpot
from professad_tpu_torch import System, system_state_from_jax
from professad_tpu_torch.ops import solvers
from professad_tpu_torch.ops.grid import spectral_resample
from professad_tpu_torch.models import potentials as tpot
from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                        WangTeter, PerdewBurkeErnzerhof)
from paths import pot

SHAPE = (12, 12, 12)
FRAC = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0],
                 [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]])
J_TERMS = [jIonIon, jIonElectron, jHartree, jWangTeter, jPBE]
T_TERMS = [IonIon, IonElectron, Hartree, WangTeter, PerdewBurkeErnzerhof]


def _ions():
    return [["Al", pot("al.gga.recpot"), FRAC]]


@pytest.fixture(scope="module")
def pair():
    """The bench system (4-atom cubic fcc Al, WT+PBE) in both packages,
    the JAX one carrying a seeded non-uniform density."""
    js = jsys.System(jnp.asarray(4.05 * np.eye(3)), SHAPE,
                     [["Al", pot("al.gga.recpot"), jnp.asarray(FRAC)]],
                     J_TERMS, units="a", coord_type="fractional")
    den = 1.0 + 0.2 * np.random.default_rng(11).random(SHAPE)
    den *= js._N_elec / (den.mean() * js.volume("b3"))
    js.set_density(jnp.asarray(den))
    ts = System(4.05 * np.eye(3), SHAPE, _ions(), T_TERMS, units="a",
                coord_type="fractional", device="cpu")
    return js, ts


def test_vext_and_ion_ion_match_jax(pair):
    js, ts = pair
    v_ref = np.asarray(js._v_ext)
    v = ts.ionic_potential().numpy()
    assert np.max(np.abs(v - v_ref)) <= 1e-12 * np.max(np.abs(v_ref))
    cart = ts._frac_ion_coords @ ts._box_vecs
    E_ii = float(ts._ion_ion_interaction(ts._box_vecs, cart))
    E_ii_ref = float(js._ion_ion_interaction(
        js._box_vecs, js._frac_ion_coords @ js._box_vecs))
    assert abs(E_ii - E_ii_ref) <= 1e-12 * abs(E_ii_ref)


def test_state_from_jax_round_trip(pair):
    js, ts = pair
    state = system_state_from_jax(js.state_dict(), device="cpu")
    assert state["den"].dtype == torch.float64
    ts.load_state_dict(state)
    assert abs(ts.energy() - js.energy()) <= 1e-10 * abs(js.energy())
    again = System(4.05 * np.eye(3), SHAPE, _ions(), T_TERMS, units="a",
                   coord_type="fractional", device="cpu")
    again.load_state_dict(ts.state_dict())
    assert again.energy() == ts.energy()


def test_five_tpgd_iterations_match_jax(pair):
    """Five preconditioned BB2 iterations from the uniform start: the JAX
    package's tpgd_iteration against the port's tpgd_minimize loop (no
    damping yet: it needs six stagnant iterations)."""
    js, ts = pair
    N = float(ts._N_elec)
    box_np, vext_np = ts._box_vecs.numpy(), ts._v_ext.numpy()
    chi0 = np.full(SHAPE, np.sqrt(N / ts.volume("b3")))

    jbox, jvext = jnp.asarray(box_np), jnp.asarray(vext_np)
    Mj = jax.jit(js._exact_precond_kernel)(jbox, N)
    vg_j = jax.jit(lambda x: js._chi_value_and_grad_analytic(
        x, jbox, jvext, N))
    x0 = jnp.asarray(chi0)
    f0, g0 = vg_j(x0)
    st_j = jsolvers.TPGDState(x=x0, f=f0, g=g0, g_prev=g0,
                              Mg_prev=jnp.zeros_like(g0),
                              s_prev=jnp.zeros_like(g0),
                              n_iter=jnp.zeros((), jnp.int32))
    best = (float(st_j.f), st_j.x)
    for _ in range(5):
        st_j = jsolvers.tpgd_iteration(vg_j, st_j, 1.0,
                                       apply_H0=js._apply_spectral(Mj))
        best = min(best, (float(st_j.f), st_j.x), key=lambda b: b[0])

    box, vext = torch.tensor(box_np), torch.tensor(vext_np)
    Mt = ts._exact_precond_kernel(box, N)
    st, n_it, conv = solvers.tpgd_minimize(
        lambda x: ts._chi_value_and_grad_analytic(x, box, vext, N),
        torch.tensor(chi0), lr=1.0, ntol=1e-7, max_iter=5,
        apply_H0=ts._apply_spectral(Mt))
    assert n_it == 5 and not conv
    # the port returns the best iterate, as the JAX tpgd_minimize does
    assert abs(float(st.f) - best[0]) <= 1e-10 * abs(best[0])
    x_ref = np.asarray(best[1])
    assert np.max(np.abs(st.x.numpy() - x_ref)) <= 1e-10 * np.max(
        np.abs(x_ref))


def test_golden_energy_fcc_al_through_tpgd_path():
    """Primitive fcc Al, WT+PBE, 18^3 (the PROFESS-4 golden case of
    tests/test_match_profess4.py) through the port's main path: exact
    preconditioner, fused analytic gradient, TPGD."""
    cell = 4.050 * np.array([[0.5, 0.5, 0.0], [0.0, 0.5, 0.5],
                             [0.5, 0.0, 0.5]])
    s = System(cell, (18, 18, 18), [["Al", pot("al.gga.recpot"),
                                     np.zeros((1, 3))]], T_TERMS,
               units="a", coord_type="fractional", device="cpu")
    n_it, conv = s.optimize_density(ntol=1e-7, n_method="TPGD",
                                    analytic=True, precondition=True,
                                    n_step_size=1.0, skip_iters=2,
                                    jit_loop=True)
    assert conv, n_it
    assert abs(s.energy("eV") - (-57.183329401794985)) < 1e-4
    assert s.density().dtype == torch.float64


def _potentials(box_vecs, den):
    raise AssertionError("never evaluated")


@pytest.mark.parametrize("kwargs", [
    dict(n_method="LBFGS", mesh=object()),
    dict(n_method="TPGD", analytic=False, jit_loop=True, mesh=object()),
    dict(n_method="TPGD", precondition=None, mesh=object()),
    dict(n_method="TPGD", conv_target="euler", mesh=object()),
], ids=["lbfgs", "autograd", "unpreconditioned", "euler"])
def test_unported_options_raise(pair, kwargs):
    """A ``mesh=`` the mesh path cannot take (not a DeviceMesh with a
    "grid" axis, or without ``jit_loop=True``) raises ValueError on every
    solver setting."""
    _, ts = pair
    with pytest.raises(ValueError, match="mesh"):
        ts.optimize_density(**kwargs)


def test_mesh_raises(pair):
    _, ts = pair
    ts.set_mesh(None)
    with pytest.raises(ValueError, match="grid"):
        ts.set_mesh(object())
    with pytest.raises(ValueError, match="autodiff gradients only"):
        ts.optimize_density(jit_loop=True, potentials=_potentials)


def test_getters_and_setters_match_jax(pair):
    js, ts = pair
    assert ts.name() == js.name() == "Al4"
    assert ts.device() == torch.device("cpu")
    assert ts.ions() == js.ions()
    for units in ("a", "b"):
        assert np.allclose(ts.lattice_vectors(units).numpy(),
                           np.asarray(js.lattice_vectors(units)),
                           rtol=1e-15, atol=0)
    assert np.array_equal(ts.fractional_ionic_coordinates().numpy(),
                          np.asarray(js.fractional_ionic_coordinates()))
    other = System(4.05 * np.eye(3), SHAPE, _ions(), T_TERMS, units="a",
                   coord_type="fractional", device="cpu")
    v = np.random.default_rng(4).standard_normal(SHAPE)
    other.set_potential(v)
    assert np.array_equal(other.ionic_potential().numpy(), v)
    with pytest.raises(ValueError, match="potential"):
        other.set_potential(np.zeros((4, 4, 4)))
    other.set_electron_number(11)
    assert other.electron_count() == 11
    E0 = other.energy()
    other.set_Rc(30.0)
    assert other._Rc_Rd()[0] == 30.0
    other.set_Rc()
    assert other._Rc_Rd() == ts._Rc_Rd()
    other.detach()
    assert other.energy() == E0


def test_spectral_resample_matches_jax():
    rng = np.random.default_rng(8)
    for old, new in (((9, 8, 10), (12, 15, 7)), ((12, 12, 12), (8, 9, 12)),
                     ((6, 7, 8), (6, 7, 8))):
        f = rng.standard_normal(old)
        ref = np.asarray(jresample(jnp.asarray(f), new))
        out = spectral_resample(torch.tensor(f), new).numpy()
        assert out.shape == new
        assert np.max(np.abs(out - ref)) <= 1e-13 * np.max(np.abs(ref))
        assert abs(out.mean() - f.mean()) <= 1e-14


def test_set_density_resample_matches_jax(pair):
    """A coarse density seeds the 12^3 grid (chi resampled, renormalised)
    in both packages; without ``resample`` another shape raises."""
    js, ts = pair
    saved = js.state_dict()
    coarse = 1.0 + 0.3 * np.random.default_rng(9).random((8, 8, 8))
    js.set_density(jnp.asarray(coarse), resample=True)
    other = System(4.05 * np.eye(3), SHAPE, _ions(), T_TERMS, units="a",
                   coord_type="fractional", device="cpu")
    other.set_density(coarse, resample=True)
    ref = np.asarray(js.density())
    assert np.max(np.abs(other.density().numpy() - ref)) <= 1e-12 * ref.max()
    assert abs(other.energy() - js.energy()) <= 1e-10 * abs(js.energy())
    js.load_state_dict(saved)
    with pytest.raises(ValueError, match="resample=True"):
        other.set_density(coarse)


@pytest.mark.parametrize("n_method", ["LBFGS", "TPGD"])
def test_optimize_density_potentials_match_jax(pair, n_method):
    """The host loop driven by a user-supplied potential (each package's
    fused analytic one) from the uniform start: the same density and
    energy as the JAX package."""
    js, ts = pair
    saved = js.state_dict()
    jv = js._v_ext
    js.optimize_density(
        ntol=1e-8, n_method=n_method, from_uniform=True,
        potentials=lambda b, n: jpot.value_and_potential(J_TERMS, b, n,
                                                         jv)[1])
    other = System(4.05 * np.eye(3), SHAPE, _ions(), T_TERMS, units="a",
                   coord_type="fractional", device="cpu")
    tv = other._v_ext
    n_it, conv = other.optimize_density(
        ntol=1e-8, n_method=n_method, from_uniform=True,
        potentials=lambda b, n: tpot.value_and_potential(T_TERMS, b, n,
                                                         tv)[1])
    assert conv
    assert abs(other.energy("eV") - js.energy("eV")) < 1e-9
    ref = np.asarray(js.density())
    assert np.max(np.abs(other.density().numpy() - ref)) <= 1e-7 * ref.max()
    js.load_state_dict(saved)


def test_save_and_load_both_ways(pair, tmp_path):
    """A checkpoint round-trips through the port, the port's loads into the
    JAX package and the JAX package's into the port, energies kept."""
    js, ts = pair
    saved = js.state_dict()
    jax_file, port_file = tmp_path / "jax.pkl", tmp_path / "port.pkl"
    js.save(str(jax_file))
    other = System(4.05 * np.eye(3), SHAPE, _ions(), T_TERMS, units="a",
                   coord_type="fractional", device="cpu")
    other.load(jax_file)
    assert np.array_equal(other.density().numpy(), np.asarray(js.density()))
    assert abs(other.energy() - js.energy()) <= 1e-10 * abs(js.energy())
    R = other.cartesian_ionic_coordinates().numpy()
    R[1] += 0.05
    other.place_ions(R)
    other.save(port_file)
    again = System(4.05 * np.eye(3), SHAPE, _ions(), T_TERMS, units="a",
                   coord_type="fractional", device="cpu")
    again.load(port_file)
    assert again.energy() == other.energy()
    js.load(str(port_file))
    assert abs(js.energy() - other.energy()) <= 1e-10 * abs(other.energy())
    js.load_state_dict(saved)


def test_functional_params_from_jax():
    from professad_tpu.models import WangTeterStyleFunctional as jWTSF
    from professad_tpu_torch.models import WangTeterStyleFunctional
    from professad_tpu_torch.convert import functional_params_from_jax
    jf = jWTSF((0.7, 0.9, lambda x: 1.0 + x))
    params = functional_params_from_jax(
        {k: np.asarray(v) for k, v in jf.params.items()})
    assert set(params) == {"alpha", "beta"}
    assert params["alpha"].dtype == torch.float64
    tf = WangTeterStyleFunctional((5.0 / 6.0, 5.0 / 6.0, torch.exp))
    tf.load_params(params)
    assert float(tf.params["alpha"].detach()) == 0.7
    assert float(tf.params["beta"].detach()) == 0.9


def test_no_device_means_the_card():
    """``device=None`` means cuda:0: without a card, building a System or
    converting a JAX state raises rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; tests/test_torch_cuda.py "
                    "checks the default there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        System(4.05 * np.eye(3), SHAPE, _ions(), T_TERMS, units="a",
               coord_type="fractional")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        system_state_from_jax({"box_vecs": np.eye(3),
                               "frac_ion_coords": np.zeros((1, 3)),
                               "den": np.ones(SHAPE), "v_ext": np.ones(SHAPE),
                               "N_elec": 3, "shape": SHAPE, "ions": []})


def test_import_loads_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import importlib, pkgutil, sys, professad_tpu_torch; "
            "[importlib.import_module(m.name) for m in pkgutil.walk_packages("
            "professad_tpu_torch.__path__, 'professad_tpu_torch.')]; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'professad_tpu' "
            "or m.startswith('professad_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
