"""The System's cached preconditioner kernel M(k)
(``System._cell_precond_kernel``), f64 on the CPU, on small cuts of the
benchmark's cells: hcp Mg (2 ions) and fcc Al (4 ions), WT-exp + PBE.

A solve on an unchanged cell takes the kernel the last build made: the
very tensor a fresh ``_exact_precond_kernel`` / ``_exact_precond_kernel_
radial`` returns, so densities, energies and iteration counts are bitwise
those of rebuilding it every solve.  What the kernel is built from (the
cell, N_elec, the dtype, a trainable term's parameters) misses when it
changes; a term with ``prepare`` (Huang-Carter) or one whose state is not
visible never hits.  The counters ``system.precond_kernel_builds`` /
``precond_kernel_hits`` say which happened."""

import numpy as np
import pytest
import torch

from professad_tpu_torch import System
from professad_tpu_torch import system as tsys
from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                        WangTeterStyleFunctional,
                                        PerdewBurkeErnzerhof, HuangCarter)
from professad_tpu_torch.ops import solvers
from paths import pot

AL_FRAC = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5],
                    [0.0, 0.5, 0.5]])
MG_FRAC = np.array([[1.0 / 3.0, 2.0 / 3.0, 0.25],
                    [2.0 / 3.0, 1.0 / 3.0, 0.75]])
# the benchmark's solver (TPGD, fused analytic gradient, preconditioned)
KW = dict(ntol=1e-9, n_method="TPGD", analytic=True, precondition=True,
          jit_loop=True, n_step_size=1.0, skip_iters=2, n_conv_cond_count=3)
SYSTEMS = ["mg", "al"]


def _hcp_box(vol_per_atom=23.151, c_over_a=1.630):
    a = (2.0 * vol_per_atom / (np.sqrt(3.0) / 2.0 * c_over_a)) ** (1 / 3)
    return np.array([[a, 0.0, 0.0], [-a / 2, a * np.sqrt(3.0) / 2, 0.0],
                     [0.0, 0.0, c_over_a * a]])


def _system(name, kinetic=None, dtype=torch.float64):
    """The cut: Mg at the benchmark's volume and c/a on (10, 10, 16), or
    Al at 4.05 A on 12^3; WT-exp unless ``kinetic`` is given."""
    kinetic = kinetic or WangTeterStyleFunctional(
        (5.0 / 6.0, 5.0 / 6.0, torch.exp)).forward
    terms = [IonIon, IonElectron, Hartree, kinetic, PerdewBurkeErnzerhof]
    if name == "mg":
        box, shape, ions = _hcp_box(), (10, 10, 16), [
            ["Mg", pot("mg.gga.recpot"), MG_FRAC]]
    else:
        box, shape, ions = 4.05 * np.eye(3), (12, 12, 12), [
            ["Al", pot("al.gga.recpot"), AL_FRAC]]
    return System(box, shape, ions, terms, units="a",
                  coord_type="fractional", device="cpu", dtype=dtype)


def _counts():
    return tsys.precond_kernel_builds, tsys.precond_kernel_hits


def _since(c0):
    b, h = _counts()
    return b - c0[0], h - c0[1]


def _displaced(s, k, sigma=0.1):
    """k snapshots of the System's ions displaced by a Gaussian of sigma A
    a component (gs-cold traffic), Cartesian A."""
    cart = (s.fractional_ionic_coordinates() @ s.lattice_vectors("a"))
    rng = np.random.default_rng(11)
    return [cart.numpy() + sigma * rng.standard_normal(cart.shape)
            for _ in range(k)]


def _solves(s, snapshots, from_uniform, clear):
    """place_ions + optimize_density for each snapshot; ``clear`` drops
    the cache entry before each solve (a rebuild every solve, as without
    the cache).  Returns [(density, energy, iterations, converged)]."""
    out = []
    for cart in snapshots:
        s.place_ions(cart, coord_type="cartesian", units="a")
        if clear:
            s._precond_entry = None
        n_it, conv = s.optimize_density(from_uniform=from_uniform, **KW)
        out.append((s.density().clone(), s.energy(), n_it, conv))
    return out


@pytest.mark.parametrize("name", SYSTEMS)
@pytest.mark.parametrize("route", ["full", "radial"])
def test_cached_kernel_is_the_fresh_one(monkeypatch, name, route):
    """The entry is the tensor a fresh build returns, bitwise, on both
    routes; the second call is a hit and returns that very tensor."""
    s = _system(name)
    box, N = s._box_vecs, float(s._N_elec)
    if route == "radial":
        # the ray the route takes above 256^3, at this cut's grid
        monkeypatch.setattr(s, "_radial_n1d", lambda: 1024)
        fresh = s._exact_precond_kernel_radial(box, N, n1d=1024)
    else:
        fresh = s._exact_precond_kernel(box, N)
    c0 = _counts()
    M = s._cell_precond_kernel(torch.float64)
    assert _since(c0) == (1, 0)
    assert s._cell_precond_kernel(torch.float64) is M
    assert _since(c0) == (1, 1)
    assert M.dtype == torch.float64 and torch.equal(M, fresh)
    # the f64 full-grid kernel of the second derivatives is the same entry
    # on the full route, a miss on the radial one
    s._cg_precond()
    assert _since(c0) == ((1, 2) if route == "full" else (2, 1))


@pytest.mark.parametrize("name", SYSTEMS)
@pytest.mark.parametrize("from_uniform", [True, False],
                         ids=["gs-cold", "md-warm"])
def test_solves_after_place_ions_hit(name, from_uniform):
    """k = 3 solves after ``place_ions``: one build and two hits, and
    densities, energies and iteration counts bitwise those of the same
    solves with the entry cleared before each."""
    s = _system(name)
    snaps = _displaced(s, 3)
    s.initialize_density()
    c0 = _counts()
    cached = _solves(s, snaps, from_uniform, clear=False)
    assert _since(c0) == (1, 2)
    s.initialize_density()
    c0 = _counts()
    rebuilt = _solves(s, snaps, from_uniform, clear=True)
    assert _since(c0) == (3, 0)
    for (d0, e0, n0, v0), (d1, e1, n1, v1) in zip(cached, rebuilt):
        assert v0 and (n0, v0) == (n1, v1)
        assert torch.equal(d0, d1) and e0 == e1


def _set_lattice(s, wt):
    s.set_lattice(s.lattice_vectors("a") * 1.01, units="a")


def _load_params(s, wt):
    wt.load_params({"alpha": 0.8, "beta": 0.85})


def _update_params(s, wt):
    # the first Rprop step applies the zero update of the lag: a miss on
    # the version alone, with the same values
    wt.update_params(lambda p: p["alpha"] * p["beta"])


def _dtype(s, wt):
    s._dtype = torch.float32


@pytest.mark.parametrize("name", SYSTEMS)
@pytest.mark.parametrize("change", [_set_lattice, _load_params,
                                    _update_params, _dtype],
                         ids=["set_lattice", "load_params", "update_params",
                              "dtype"])
def test_miss_after_change(name, change):
    """A change of what M is built from is a miss, whose kernel is the
    fresh build of the new state; the next call hits again."""
    wt = WangTeterStyleFunctional((5.0 / 6.0, 5.0 / 6.0, torch.exp))
    s = _system(name, kinetic=wt.forward)
    kw = dict(KW, n_maxiter=10)
    s.optimize_density(from_uniform=True, **kw)
    c0 = _counts()
    change(s, wt)
    s.optimize_density(from_uniform=True, **kw)
    assert _since(c0) == (1, 0)
    M = s._precond_entry[2]
    assert torch.equal(M, s._exact_precond_kernel(
        s._box_vecs.to(s._dtype), float(s._N_elec)))
    s.optimize_density(from_uniform=True, **kw)
    assert _since(c0) == (1, 1) and s._precond_entry[2] is M


_cached_kernel = System._cell_precond_kernel


def _uncached_kernel(self, dtype, full_grid=False, aux=None):
    """The kernel built on every call, without the cache: the entry is
    dropped before each build."""
    self._precond_entry = None
    return _cached_kernel(self, dtype, full_grid, aux)


@pytest.mark.parametrize("term", ["HuangCarter", "lambda"])
def test_invisible_state_never_hits(monkeypatch, term):
    """Huang-Carter (``prepare``: M depends on the ladder of the current
    density) and a term wrapped in a lambda (state the key cannot see)
    build on every solve, and their solves equal those of a kernel built
    on every call without the cache."""
    if term == "HuangCarter":
        kinetic = HuangCarter((0.45, 0.51, 1.2)).forward
    else:
        wt = WangTeterStyleFunctional((5.0 / 6.0, 5.0 / 6.0, torch.exp))
        kinetic = lambda box, den: wt(box, den)  # noqa: E731
    s = _system("al", kinetic=kinetic)
    snaps = _displaced(s, 2)
    # a lambda has no fused potential: the autograd gradient
    kw = dict(KW, n_maxiter=8, analytic=term == "HuangCarter")
    c0 = _counts()
    got = []
    for cart in snaps:
        s.place_ions(cart, coord_type="cartesian", units="a")
        got.append((s.optimize_density(from_uniform=True, **kw),
                    s.density().clone(), s.energy()))
    assert _since(c0) == (2, 0) and s._precond_entry is None
    monkeypatch.setattr(System, "_cell_precond_kernel", _uncached_kernel)
    for cart, (res, den, E) in zip(snaps, got):
        s.place_ions(cart, coord_type="cartesian", units="a")
        assert s.optimize_density(from_uniform=True, **kw) == res
        assert torch.equal(s.density(), den) and s.energy() == E


@pytest.mark.parametrize("name", SYSTEMS)
def test_kernel_is_not_written_by_a_graph_solve(monkeypatch, name):
    """M's version is unchanged after a solve whose iterations run through
    the graph's body (its capture standing in as a plain call on the CPU,
    as in ``test_torch_tpgd_graph.py``) and after a second derivative's
    CG solves, and the entry is still that tensor."""
    monkeypatch.setattr(solvers, "_graph_engages",
                        lambda capturable, x0, group, stop_fn:
                        capturable and group is None and stop_fn is None)
    monkeypatch.setattr(solvers, "_cuda_graph", lambda fn, device: fn)
    s = _system(name)
    M = s._cell_precond_kernel(torch.float64)
    version = M._version
    replays = solvers.graph_replays
    n_it, conv = s.optimize_density(from_uniform=True, **KW)
    assert conv and solvers.graph_replays - replays == n_it - 1
    s.bulk_modulus()
    assert s._precond_entry[2] is M and M._version == version
