"""The last of the JAX package's public surface in the port, against the
JAX package in f64 on the CPU: the grid helpers ``rfft_shape``, ``expi``
and ``wavenumbers``; ``tpgd_minimize``'s ``stag_k`` and ``track_best``
(serial and per lane); ``ion_interaction_sum``'s ``chunk``.

The 16^3 main-path solves run the port's fused analytic gradient and
preconditioner (its plain version on the CPU) beside the JAX package's
jitted ``tpgd_minimize`` on the JAX terms' chi energy, fed the port's
v_ext and preconditioner kernel (each equal to the JAX package's at 1e-12
in ``test_torch_potentials.py``), as ``test_torch_parallel.py`` does: a
JAX ``System``'s eager set-up would cost more than the whole file.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from professad_tpu.ops import grid as jgrid
from professad_tpu.ops import solvers as jsolvers
from professad_tpu.models import ions as jions
from professad_tpu.models import (IonElectron as jIonElectron,
                                  Hartree as jHartree,
                                  WangTeter as jWangTeter,
                                  PerdewBurkeErnzerhof as jPBE)
from professad_tpu_torch import System
from professad_tpu_torch.ops import grid, solvers
from professad_tpu_torch.models import ions
from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                        WangTeter, PerdewBurkeErnzerhof)
from paths import pot

EV_PER_HA = 27.211386245988
FCC = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0],
                [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]])


def _box(seed):
    rng = np.random.default_rng(seed)
    return 7.3 * np.eye(3) + 0.4 * rng.standard_normal((3, 3))


@pytest.mark.parametrize("shape", [(16, 16, 16), (9, 15, 7), (4, 6, 1),
                                   (27, 27, 39)])
def test_rfft_shape(shape):
    assert grid.rfft_shape(shape) == jgrid.rfft_shape(shape)
    assert grid.rfft_shape(shape) == torch.fft.rfftn(
        torch.zeros(shape)).shape


def test_expi_matches_jax():
    theta = np.random.default_rng(3).uniform(-40.0, 40.0, (7, 9, 5))
    want = np.asarray(jgrid.expi(jnp.asarray(theta)))
    got = grid.expi(torch.tensor(theta))
    assert got.dtype == torch.complex128
    assert np.max(np.abs(got.numpy() - want)) <= 1e-15
    assert grid.expi(torch.tensor(theta, dtype=torch.float32)).dtype \
        == torch.complex64


@pytest.mark.parametrize("shape", [(12, 10, 9), (16, 16, 16)])
def test_wavenumbers_match_jax(shape):
    box = _box(sum(shape))
    want = np.asarray(jgrid.wavenumbers(jnp.asarray(box), shape))
    got = grid.wavenumbers(torch.tensor(box), shape)
    assert got.shape == grid.rfft_shape(shape) and got[0, 0, 0] == 0.0
    assert np.max(np.abs(got.numpy() - want)) <= 1e-15 * np.max(want)
    k2 = grid.wavevecs(torch.tensor(box), shape)[3]
    assert torch.equal(got, grid.safe_sqrt(k2))


def _overshoot():
    """tests/test_solvers.py:101-125: an overshooting first step leaves the
    start as the best point after one iteration."""
    A = torch.diag(torch.tensor([1.0, 4.0], dtype=torch.float64))

    def vg(x):
        return 0.5 * x @ (A @ x), A @ x

    return vg, torch.tensor([1.0, 1.0], dtype=torch.float64)


@pytest.mark.parametrize("track_best", [True, False])
def test_tpgd_minimize_track_best(track_best):
    vg, x0 = _overshoot()
    f0 = float(vg(x0)[0])
    st, it, _ = solvers.tpgd_minimize(vg, x0, lr=400.0, ntol=1e-30,
                                      conv_count=3, max_iter=1,
                                      track_best=track_best)
    assert it == 1
    if track_best:
        assert float(st.f) == f0 and torch.equal(st.x, x0)
    else:                  # the raw step overshot, and it is returned
        assert float(st.f) > f0 and not torch.equal(st.x, x0)


@pytest.fixture(scope="module")
def main_path():
    """The main path's configuration at 16^3 f64: 4-atom cubic fcc Al,
    IonElectron + Hartree + WT + PBE, from the uniform start, with the
    exact preconditioner; the port's and the JAX package's (E, dE/dchi)."""
    s = System(4.050 * np.eye(3), (16, 16, 16),
               [["Al", pot("al.gga.recpot"), FCC]],
               [IonIon, IonElectron, Hartree, WangTeter,
                PerdewBurkeErnzerhof], units="a", coord_type="fractional",
               device="cpu")
    N, vol = float(s._N_elec), s.volume("b3")
    box, v_ext = s._box_vecs, s._v_ext
    M = s._exact_precond_kernel(box, N)
    chi0 = grid.safe_sqrt(s._uniform_density())
    jbox, jv, jM = (jnp.asarray(t.numpy()) for t in (box, v_ext, M))

    def chi_energy(chi):
        den = N * chi * chi / (jnp.mean(chi * chi) * vol)
        return (jIonElectron(jbox, den, jv) + jHartree(jbox, den)
                + jWangTeter(jbox, den) + jPBE(jbox, den))

    return dict(
        vg=lambda x: s._chi_value_and_grad_analytic(x, box, v_ext, N),
        M=s._apply_spectral(M), chi0=chi0,
        jvg=jax.value_and_grad(chi_energy), jchi0=jnp.asarray(chi0.numpy()),
        jM=lambda q: jnp.fft.irfftn(jM * jnp.fft.rfftn(q), q.shape))


SOLVE = dict(lr=1.0, ntol=1e-9, conv_count=3, max_iter=200,
             f_scale=EV_PER_HA, skip_iters=2)


@pytest.mark.parametrize("stag_k", [3, 6])
@pytest.mark.parametrize("track_best", [True, False])
def test_tpgd_main_path_matches_jax(main_path, stag_k, track_best):
    m = main_path
    st, it, conv = solvers.tpgd_minimize(m["vg"], m["chi0"], apply_H0=m["M"],
                                         stag_k=stag_k,
                                         track_best=track_best, **SOLVE)
    jst, jit_, jconv = jax.jit(lambda x: jsolvers.tpgd_minimize(
        m["jvg"], x, apply_H0=m["jM"], stag_k=stag_k,
        track_best=track_best, **SOLVE))(m["jchi0"])
    assert conv and bool(jconv)
    assert it == int(jit_)
    assert abs(float(st.f) - float(jst.f)) <= 1e-10 * abs(float(jst.f))


def _lanes_problem():
    """Two lanes of a separable quadratic: lane 0 the overshooting case,
    lane 1 a well-scaled one."""
    A = np.array([[1.0, 4.0], [1.0, 2.0]])
    b = np.array([[0.0, 0.0], [0.5, -1.0]])
    x0 = np.ones((2, 2))
    return A, b, x0


@pytest.mark.parametrize("stag_k,track_best", [(6, True), (6, False),
                                               (1, True), (1, False)])
def test_tpgd_minimize_lanes_keywords(stag_k, track_best):
    """Each lane against the JAX package's vmapped ``tpgd_minimize`` with
    the same keywords: iterations, stop flags, x and f."""
    A, b, x0 = _lanes_problem()
    kw = dict(lr=400.0, ntol=1e-12, conv_count=3, max_iter=60,
              stag_k=stag_k, track_best=track_best)

    def tvg(x, a, c):
        return 0.5 * torch.sum(a * x * x) - torch.sum(c * x), a * x - c

    st, its, conv = solvers.tpgd_minimize_lanes(
        tvg, torch.tensor(x0), (torch.tensor(A), torch.tensor(b)), **kw)

    def jsolve(x, a, c):
        def vg(z):
            return 0.5 * jnp.sum(a * z * z) - jnp.sum(c * z), a * z - c
        return jsolvers.tpgd_minimize(vg, x, **kw)

    jst, jits, jconv = jax.jit(jax.vmap(jsolve))(
        jnp.asarray(x0), jnp.asarray(A), jnp.asarray(b))
    assert its == np.asarray(jits).tolist()
    assert conv == np.asarray(jconv).tolist()
    np.testing.assert_allclose(st.x.numpy(), np.asarray(jst.x), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(st.f.numpy(), np.asarray(jst.f), rtol=1e-12,
                               atol=1e-15)


@pytest.fixture(scope="module")
def ion_case():
    """Li2 in a sheared cell, one ion off its site, the JAX package's
    cutoff and image table."""
    rng = np.random.default_rng(11)
    box = 6.5 * np.eye(3) + 0.3 * rng.standard_normal((3, 3))
    frac = np.array([[0.02, 0.01, 0.0], [0.53, 0.48, 0.51]])
    coords = frac @ box
    charges = np.array([3.0, 3.0])
    Rc, Rd = 16.0, 1.4
    shifts = jions.neighbor_shifts(box, Rc)
    want = float(jions.ion_interaction_sum(
        jnp.asarray(box), jnp.asarray(coords), jnp.asarray(charges), Rc, Rd,
        shifts=shifts))
    return box, coords, charges, Rc, Rd, shifts, want


@pytest.mark.parametrize("chunk", [1, 7, 256, None])
def test_ion_interaction_sum_chunk(ion_case, chunk):
    box, coords, charges, Rc, Rd, shifts, want = ion_case
    assert len(shifts) > 256      # several chunks of 256 images
    got = float(ions.ion_interaction_sum(
        torch.tensor(box), torch.tensor(coords), torch.tensor(charges), Rc,
        Rd, shifts=shifts, chunk=chunk))
    assert abs(got - want) <= 1e-13 * abs(want)
