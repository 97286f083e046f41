"""The port's radially sampled preconditioner kernel (grids above 256^3)
against the JAX package's ``_exact_precond_kernel_radial``, in f64 on the
CPU, on the anisotropic (16, 20, 24) grid of
``tests/test_system_utils.py``: equal at rtol 1e-12; its ratio to the
full-grid HVP kernel flat within 1e-5 after dividing by the median; below
256^3 ``_cell_precond_kernel`` is the full-grid kernel, bit for bit; on the
main path's cell with ``_cell_precond_kernel``'s ray, both kernels equal the
JAX package's."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from professad_tpu import system as jsys
from professad_tpu.models import (IonIon as jIonIon,
                                  IonElectron as jIonElectron,
                                  Hartree as jHartree,
                                  WangTeter as jWangTeter,
                                  PerdewBurkeErnzerhof as jPBE)
from professad_tpu_torch import System
from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                        WangTeter, PerdewBurkeErnzerhof)
from paths import pot

BOX = 4.05 * np.array([[0.5, 0.5, 0.0], [0.0, 0.5, 0.5], [0.5, 0.0, 0.5]])
SHAPE = (16, 20, 24)
FCC = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5],
                [0.0, 0.5, 0.5]])


@pytest.fixture(scope="module")
def port():
    return System(BOX, SHAPE, [["Al", pot("al.gga.recpot"),
                                np.zeros((1, 3))]],
                  [IonIon, IonElectron, Hartree, WangTeter,
                   PerdewBurkeErnzerhof], units="a", coord_type="fractional",
                  device="cpu")


def test_radial_kernel_matches_jax(port):
    js = jsys.System(jnp.asarray(BOX), SHAPE,
                     [["Al", pot("al.gga.recpot"), jnp.zeros((1, 3))]],
                     [jIonIon, jIonElectron, jHartree, jWangTeter, jPBE],
                     units="a", coord_type="fractional")
    Ne = float(js._N_elec)
    ref = np.asarray(jax.jit(js._exact_precond_kernel_radial)(
        js._box_vecs, Ne))
    M = port._exact_precond_kernel_radial(port._box_vecs, Ne).numpy()
    assert M.shape == ref.shape
    assert np.max(np.abs(M - ref)) <= 1e-12 * np.max(np.abs(ref))


def test_radial_kernel_matches_full_hvp(port):
    Ne = float(port.electron_count())
    r = (port._exact_precond_kernel(port._box_vecs, Ne)
         / port._exact_precond_kernel_radial(port._box_vecs, Ne)).numpy()
    assert np.max(np.abs(r / np.median(r) - 1.0)) < 1e-5


def test_precond_kernel_is_full_hvp_below_threshold(port):
    Ne = float(port.electron_count())
    M = port._cell_precond_kernel(torch.float64)
    assert np.array_equal(
        M.numpy(), port._exact_precond_kernel(port._box_vecs, Ne).numpy())


@pytest.mark.parametrize("n", [
    32, pytest.param(128, marks=pytest.mark.slow)])
def test_production_ray_matches_jax(n):
    """On the main path's cell (4-atom cubic fcc Al) with the ray that
    ``_cell_precond_kernel`` uses, n1d = max(4096, 16 n): the radial and the
    full-grid kernels equal the JAX package's at rtol 1e-10, so the
    flatness of their ratio is the reference's own (128^3: ~1e-2)."""
    cell = 4.05 * np.eye(3)
    terms = ([jIonIon, jIonElectron, jHartree, jWangTeter, jPBE],
             [IonIon, IonElectron, Hartree, WangTeter, PerdewBurkeErnzerhof])
    js = jsys.System(jnp.asarray(cell), (n, n, n),
                     [["Al", pot("al.gga.recpot"), jnp.asarray(FCC)]],
                     terms[0], units="a", coord_type="fractional")
    ts = System(cell, (n, n, n), [["Al", pot("al.gga.recpot"), FCC]],
                terms[1], units="a", coord_type="fractional", device="cpu")
    Ne, n1d = float(js._N_elec), max(4096, 16 * n)
    kernels = [(np.asarray(s._exact_precond_kernel(s._box_vecs, Ne)),
                np.asarray(s._exact_precond_kernel_radial(s._box_vecs, Ne,
                                                          n1d=n1d)))
               for s in (js, ts)]
    for a, b in zip(*kernels):
        assert np.max(np.abs(b - a)) <= 1e-10 * np.max(np.abs(a))
