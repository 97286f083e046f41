"""Geometry relaxation in the port against the JAX package, f64 on the
CPU: the host optimizers on an analytic function, and ``optimize_geometry``
on bcc Li with Smargiassi-Madden + PBE at 10^3 with the ions relaxed (the
ions + cell case from the sheared cell of tests/test_geometry.py is in
tests/test_torch_geometry_cell.py and uses the check defined here).

Trajectories: the fractional coordinates and the box after each of the
first 3 geometry steps agree at rtol 1e-8.  Beyond that the two packages'
rounding (XLA's fused arithmetic against PyTorch's, ~1e-14) is amplified on
the flat frozen-density surrogate (the paths agree at 1e-10 for the first
four steps and drift apart at the level the stopping rule allows), and a
whole JAX relaxation costs 80-120 s on the CPU; so the JAX side runs the 3
steps, and the port's converged state, written by ``System.save``, is
loaded into the JAX package, whose own forces and stress must agree with
the port's at rtol 1e-9 and meet the tolerances.  The ions start shifted by
(0.1, 0.1, 0.1) from the JAX test's positions, the same crystal, so that no
coordinate sits on the wrap at 0, where a rounding difference flips the
wrapped coordinate between 0 and 1.
"""

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
FRAC = np.array([[0.12, 0.1, 0.11], [0.61, 0.59, 0.62]])
SHEAR = np.array([[1.0, 0.02, 0.0], [0.0, 1.0, 0.03], [0.01, 0.0, 1.0]])
A = 3.48


# ------------------------------ host optimizers ------------------------------

def _rosenbrock(x):
    f = np.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)
    g = np.zeros_like(x)
    g[:-1] = -400.0 * x[:-1] * (x[1:] - x[:-1] ** 2) - 2.0 * (1.0 - x[:-1])
    g[1:] += 200.0 * (x[1:] - x[:-1] ** 2)
    return f, g


OPTIMIZERS = {
    "LBFGSlinesearch": lambda m: m._HostLBFGS(lr=0.1, line_search=True),
    "LBFGS": lambda m: m._HostLBFGS(lr=0.1, line_search=False),
    "TPGD": lambda m: m._HostTPGD(lr=1e-3),
    "RPROP": lambda m: m._HostRprop(lr=0.05),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_host_optimizer_iterates_match_jax(name):
    """Eight steps on a 5-D Rosenbrock function from the same start: every
    iterate equal to the JAX package's at rtol 1e-12."""
    x_j = x_t = np.array([-1.2, 1.0, -0.5, 0.8, 1.3])
    opt_j, opt_t = OPTIMIZERS[name](jsys), OPTIMIZERS[name](tsys)
    for _ in range(8):
        x_j = opt_j.step(_rosenbrock, x_j)
        x_t = opt_t.step(_rosenbrock, x_t)
        assert np.max(np.abs(x_t - x_j)) <= 1e-12 * np.max(np.abs(x_j))
    assert _rosenbrock(x_t)[0] < _rosenbrock(np.array(
        [-1.2, 1.0, -0.5, 0.8, 1.3]))[0]


def test_cubic_minimizer_matches_jax():
    rng = np.random.default_rng(3)
    for a, fa, ga, b, fb, gb in rng.standard_normal((200, 6)):
        assert tsys._cubic_minimizer(a, fa, ga, b, fb, gb) == \
            jsys._cubic_minimizer(a, fa, ga, b, fb, gb)


# ------------------------------ optimize_geometry ----------------------------

def _record(s, log, state):
    """Log (frac, box) as numpy before each density optimization, i.e. at
    the start and after each geometry step."""
    run = s.optimize_density

    def wrapped(**kw):
        frac, box = state(s)
        log.append((np.array(frac), np.array(box)))
        return run(**kw)
    s.optimize_density = wrapped


def _jax_state(s):
    return s._frac_ion_coords, s._box_vecs


def _port_state(s):
    return s._frac_ion_coords.numpy(), s._box_vecs.numpy()


def _li(module, box, **kw):
    m = jm if module == "jax" else tm
    terms = [m.IonIon, m.IonElectron, m.Hartree, m.SmargiassiMadden,
             m.PerdewBurkeErnzerhof]
    ions = [["Li", pot("li.gga.recpot"), FRAC]]
    if module == "jax":
        return jsys.System(jnp.asarray(box), SHAPE, ions, terms, units="a",
                           coord_type="fractional")
    return tsys.System(box, SHAPE, ions, terms, units="a",
                       coord_type="fractional", device="cpu")


def _close(a, b, rtol):
    return np.max(np.abs(a - b)) <= rtol * np.max(np.abs(b))


def check_relaxation_matches_jax(tmp_path, stol):
    """Relax bcc Li in both packages (the cell too unless ``stol`` is
    None): the JAX package for 3 steps, the port to convergence; the JAX
    system starts from the port's start, loaded through ``System.save``."""
    box = A * (np.eye(3) if stol is None else SHEAR)
    ts = _li("port", box)
    js = _li("jax", box)
    start = tmp_path / "start.pkl"
    ts.save(start)
    js.load(start)
    kw = dict(ftol=0.02, stol=stol, ntol=1e-9)

    j_log, t_log = [], []
    _record(js, j_log, _jax_state)
    _record(ts, t_log, _port_state)
    assert js.optimize_geometry(g_maxiter=3, **kw) is False
    ok = ts.optimize_geometry(g_maxiter=40, **kw)
    del js.optimize_density
    assert len(j_log) == 4
    for (fj, bj), (ft, bt) in zip(j_log, t_log):
        assert _close(ft, fj, 1e-8)
        assert _close(bt, bj, 1e-8)
    if stol is None:
        assert all(np.array_equal(b, t_log[0][1]) for _, b in t_log)
    else:
        assert not np.array_equal(t_log[3][1], t_log[0][1])

    # the converged state, judged by the reference's own derivatives
    assert ok is True
    F, sigma = ts.forces("eV/a").numpy(), ts.stress("eV/a3").numpy()
    assert np.max(np.abs(F)) < 0.02
    if stol is not None:
        assert np.max(np.abs(sigma)) < stol
    end = tmp_path / "end.pkl"
    ts.save(end)
    js.load(end)
    assert _close(F, np.asarray(js.forces("eV/a")), 1e-9)
    assert _close(sigma, np.asarray(js.stress("eV/a3")), 1e-9)
    # the displaced ion is back on the bcc offset (0.5, 0.5, 0.5)
    frac = ts.fractional_ionic_coordinates().numpy()
    d = (frac[1] - frac[0]) % 1.0
    assert np.allclose(d, 0.5, atol=5e-3), d


def test_optimize_geometry_ions_matches_jax(tmp_path):
    """Ions only (``stol=None``); the cell case is in
    tests/test_torch_geometry_cell.py, so that each file stays short."""
    check_relaxation_matches_jax(tmp_path, stol=None)


@pytest.mark.parametrize("scale", [0.97, 1.0, 1.03])
def test_ion_ion_sum_barely_depends_on_the_frozen_cutoff(scale):
    """The relaxation evaluates the ion-ion sum with the cutoff, damping
    and image table of the first step's cell (as the JAX package does at
    trace time).  Against the current cell's own, over a +-3% strain of
    the sheared cell, the energy and its cell gradient agree to 1e-12
    (relative), so the freeze moves trajectories only at rounding level."""
    from professad_tpu_torch.models import ions as iu
    ts = _li("port", A * SHEAR)
    Rc0, Rd0 = ts._Rc_Rd()
    shifts0 = ts._get_shifts(Rc0)
    ts._box_vecs = ts._box_vecs * scale
    ts._shifts_key = None
    Rc, Rd = ts._Rc_Rd()
    frac = ts._frac_ion_coords
    out = []
    for rc, rd, sh in ((Rc0, Rd0, shifts0), (Rc, Rd, ts._get_shifts(Rc))):
        box = ts._box_vecs.clone().requires_grad_(True)
        E = iu.ion_interaction_sum(box, frac @ box, ts._charges, rc, rd,
                                   shifts=sh)
        (g,) = torch.autograd.grad(E, box)
        out.append((float(E), g))
    (E0, g0), (E1, g1) = out
    assert abs(E1 - E0) <= 1e-12 * abs(E1)
    assert float((g1 - g0).abs().max()) <= 1e-12 * float(g1.abs().max())


def test_optimize_geometry_options():
    ts = _li("port", A * np.eye(3))
    with pytest.raises(ValueError, match="stol/ftol"):
        ts.optimize_geometry(ftol=None, stol=None)
    with pytest.raises(ValueError, match="g_method"):
        ts.optimize_geometry(g_method="BFGS", g_maxiter=1)
    with pytest.raises(ValueError, match="grid"):
        ts.optimize_geometry(mesh=object())
