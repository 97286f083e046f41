"""The port's crystal cell generators and EOS / elastic utilities
(professad_tpu_torch/utils/crystal.py, utils/elastic.py) against the JAX
package's on the same inputs."""

import numpy as np
import pytest
import torch

from professad_tpu.utils import crystal as jcrystal
from professad_tpu.utils import elastic as jelastic
from professad_tpu_torch.utils import crystal, elastic

CRYSTALS = ["sc", "bcc", "bcc-c", "fcc", "fcc-c", "dc", "dc-c", "hcp"]
CPU = torch.device("cpu")


@pytest.mark.parametrize("coord_type", ["fractional", "cartesian"])
@pytest.mark.parametrize("name", CRYSTALS)
def test_get_cell_matches_jax(name, coord_type):
    """Every crystal in both coordinate types, f64, within 1e-14 (the
    generators are the same numpy arithmetic; the cartesian product is a
    3x3 matmul in each package)."""
    lv_j, fc_j = jcrystal.get_cell(name, 16.8, c_over_a=1.66,
                                   coord_type=coord_type)
    lv, fc = crystal.get_cell(name, 16.8, c_over_a=1.66,
                              coord_type=coord_type, device="cpu")
    for a, b in ((lv, lv_j), (fc, fc_j)):
        assert a.dtype == torch.float64 and a.device == CPU
        assert tuple(a.shape) == tuple(np.shape(b))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-14)


def test_get_cell_bad_arguments_raise():
    with pytest.raises(ValueError, match="not recognized"):
        crystal.get_cell("xyz", 16.8, device="cpu")
    with pytest.raises(ValueError, match="coord_type"):
        crystal.get_cell("fcc", 16.8, coord_type="polar", device="cpu")
    with pytest.raises(ValueError, match="cell_type"):
        crystal.face_centered_cubic(16.8, "hexagonal", device="cpu")
    with pytest.raises(ValueError, match="cell_type"):
        crystal.body_centered_cubic(16.8, "x", device="cpu")


def _eos_data(eos, seed):
    """Synthetic (V, E) from known (K0, K0', E0, V0) [eV/A^3, -, eV, A^3]
    with 1e-4 eV of seeded noise, so that the fit has work to do."""
    K0, K0p, E0, V0 = 0.05, 4.2, -57.0, 16.8
    vs = np.linspace(0.9 * V0, 1.1 * V0, 15)
    if eos == "m":
        es = (E0 + (K0 * vs / K0p) * ((((V0 / vs) ** K0p) / (K0p - 1)) + 1)
              - K0 * V0 / (K0p - 1))
    else:
        x = (V0 / vs) ** (2.0 / 3.0) - 1.0
        es = E0 + 9 * V0 * K0 / 16 * (
            K0p * x**3 + x**2 * (6 - 4 * (V0 / vs) ** (2.0 / 3.0)))
    return vs, es + 1e-4 * np.random.default_rng(seed).standard_normal(15)


@pytest.mark.parametrize("eos", ["m", "bm"])
def test_fit_eos_matches_jax(eos):
    """Same data, same scipy fit: parameters and errors within 1e-10
    relative (measured: equal to the last digit); tensors are accepted."""
    vs, es = _eos_data(eos, seed=4)
    p_j, e_j = jelastic.fit_eos(vs, es, eos=eos)
    p, e = elastic.fit_eos(torch.tensor(vs), torch.tensor(es), eos=eos)
    np.testing.assert_allclose(p, p_j, rtol=1e-10)
    np.testing.assert_allclose(e, e_j, rtol=1e-10)
    with pytest.raises(ValueError, match="'m' or 'bm'"):
        elastic.fit_eos(vs, es, eos="vinet")


def _elastic_matrix(seed):
    """A random symmetric positive definite 6x6 stiffness [GPa]."""
    A = np.random.default_rng(seed).standard_normal((6, 6))
    return 20.0 * (A @ A.T) + 50.0 * np.eye(6)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_moduli_helpers_match_jax(as_tensor):
    C = _elastic_matrix(5)
    Cin = torch.tensor(C) if as_tensor else C
    for fn in ("voigt_moduli", "reuss_moduli"):
        got = getattr(elastic, fn)(Cin)
        want = getattr(jelastic, fn)(C)
        np.testing.assert_allclose([float(g) for g in got],
                                   [float(w) for w in want], rtol=1e-13)
    for mean in ("arithmetic", "geometric"):
        np.testing.assert_allclose(float(elastic.shear_average(Cin, mean)),
                                   float(jelastic.shear_average(C, mean)),
                                   rtol=1e-13)
    K, G = (float(v) for v in jelastic.voigt_moduli(C))
    np.testing.assert_allclose(elastic.poissons_ratio(K, G),
                               jelastic.poissons_ratio(K, G), rtol=1e-15)
    np.testing.assert_allclose(elastic.youngs_modulus(K, G),
                               jelastic.youngs_modulus(K, G), rtol=1e-15)
    with pytest.raises(ValueError, match="mean_type"):
        elastic.shear_average(Cin, "harmonic")
