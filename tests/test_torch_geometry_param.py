"""``optimize_parameterized_geometry`` in the port against the JAX package:
primitive fcc Al (WT + PBE, 10^3) relaxed over its lattice constant, as in
tests/test_geometry.py.  The lattice constant after each of the first 3
steps agrees at rtol 1e-6: within a step the 1-D surrogate converges, and
the line search's last comparisons are between energies that differ by
less than their rounding, so the gradients' rounding-level difference
(``test_geometry_objective_matches_jax``) shifts the step at up to ~1e-7.  The port's
converged cell, written by ``System.save`` and loaded into the JAX
package, has the reference's own stress equal to the port's at rtol 1e-9
and below ``stol``, and lies in the WT+PBE band 3.8-4.2 A of
tests/test_geometry.py.  (As in
tests/test_torch_geometry.py, the JAX side runs only the 3 steps: a whole
JAX relaxation costs over a minute on the CPU.)"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from professad_tpu import system as jsys
from professad_tpu import models as jm
from professad_tpu_torch import system as tsys
from professad_tpu_torch import models as tm
from paths import pot

SHAPE = (10, 10, 10)
PRIM = np.array([[0.5, 0.5, 0.0], [0.0, 0.5, 0.5], [0.5, 0.0, 0.5]])
A0 = 4.15 / tsys.System.A_per_b  # start away from equilibrium (bohr)


def jax_geom(p):
    return p[0] * jnp.asarray(PRIM), jnp.zeros((1, 3))


def port_geom(p):
    return p[0] * torch.tensor(PRIM, dtype=p.dtype, device=p.device), \
        torch.zeros((1, 3), dtype=p.dtype, device=p.device)


IONS = [["Al", pot("al.gga.recpot"), np.zeros((1, 3))]]


@pytest.fixture(scope="module")
def jax_al():
    """The JAX system, built once (its setup is most of this file's time);
    neither test changes its state before the relaxation, the last."""
    return jsys.System(jnp.asarray(A0 * PRIM), SHAPE, IONS,
                       [jm.IonIon, jm.IonElectron, jm.Hartree, jm.WangTeter,
                        jm.PerdewBurkeErnzerhof], units="b",
                       coord_type="fractional")


def _port_al():
    return tsys.System(A0 * PRIM, SHAPE, IONS,
                       [tm.IonIon, tm.IonElectron, tm.Hartree, tm.WangTeter,
                        tm.PerdewBurkeErnzerhof], units="b",
                       coord_type="fractional", device="cpu")


def test_geometry_objective_matches_jax(jax_al):
    """The frozen-density objective the host optimizer sees, value and
    gradient in the lattice constant, against the JAX package's objective
    (the body of its ``optimize_parameterized_geometry``, assembled from
    the same System methods) at three lattice constants: the energy at
    rtol 1e-12, the gradient at 1e-12 Ha/bohr (it is the near-cancelling
    sum of O(1) term gradients, so its rounding is absolute)."""
    import jax
    from professad_tpu.ops.grid import wmean, volume
    js, ts = jax_al, _port_al()
    chi = np.sqrt(0.9 + 0.2 * np.random.default_rng(2).random(SHAPE))

    def jax_energy(p, chi):
        box, frac = jax_geom(p)
        v_ext = js._potential_from_ions(box, frac @ box)
        den = (js._N_elec / (wmean(chi * chi) * volume(box))) * chi * chi
        return (js._density_terms_energy(box, den, v_ext)
                + js._ion_ion_interaction(box, frac @ box))

    vg_j = jax.jit(jax.value_and_grad(jax_energy))
    vg_t = ts._geometry_value_and_grad(
        lambda p: tuple(ts._t(v) for v in reversed(port_geom(p))),
        {"chi": torch.tensor(chi)})
    for a in (A0, 1.01 * A0, 0.97 * A0):
        f_j, g_j = vg_j(np.array([a]), jnp.asarray(chi))
        f_t, g_t = vg_t(np.array([a]))
        assert abs(f_t - float(f_j)) <= 1e-12 * abs(float(f_j))
        assert abs(g_t[0] - float(g_j[0])) <= 1e-12


def _record(s, log):
    run = s.optimize_density

    def wrapped(**kw):
        log.append(float(np.asarray(s._box_vecs)[0, 0]) * 2.0)
        return run(**kw)
    s.optimize_density = wrapped


def test_parameterized_lattice_constant_matches_jax(jax_al, tmp_path):
    kw = dict(ftol=None, stol=0.002, ntol=1e-9)
    js, ts = jax_al, _port_al()
    j_log, t_log = [], []
    _record(js, j_log)
    _record(ts, t_log)
    ok_j, _ = js.optimize_parameterized_geometry(
        jnp.asarray([A0]), jax_geom, g_maxiter=3, **kw)
    ok, p_opt = ts.optimize_parameterized_geometry(
        np.array([A0]), port_geom, g_maxiter=40, **kw)
    assert ok_j is False and len(j_log) == 4
    for a_j, a_t in zip(j_log, t_log):
        assert abs(a_t - a_j) <= 1e-6 * a_j
    assert len(set(t_log[:4])) == 4  # the lattice constant moved each step

    assert ok is True
    assert p_opt.dtype == torch.float64 and p_opt.shape == (1,)
    a_opt = float(p_opt[0]) * tsys.System.A_per_b
    assert 3.8 < a_opt < 4.2, a_opt
    sigma = ts.stress("eV/a3").numpy()
    assert np.max(np.abs(sigma)) < 0.002
    path = tmp_path / "end.pkl"
    ts.save(path)
    del js.optimize_density
    js.load(path)
    ref = np.asarray(js.stress("eV/a3"))
    assert np.max(np.abs(sigma - ref)) <= 1e-9 * np.max(np.abs(ref))
