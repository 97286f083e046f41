"""Linear response G^-1(eta), stress and pressure of a functional in the
port (professad_tpu_torch/ops/autodiff.py): against the closed forms of
tests/test_linear_response.py, and against the JAX package's functions on
the same inputs."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from professad_tpu.ops import autodiff as jad
from professad_tpu import models as jm
from professad_tpu_torch.ops import autodiff as ad
from professad_tpu_torch import models as tm

N_LR = 61   # the grid of tests/test_linear_response.py


def _uniform():
    return (8 * torch.eye(3, dtype=torch.float64),
            torch.ones((N_LR,) * 3, dtype=torch.float64))


def test_wang_teter_reproduces_lindhard():
    """Measured max |diff| 2.5e-13 (bound 1e-10)."""
    box, den = _uniform()
    _, G_lind = tm.G_inv_lindhard(box, den)
    _, G_wt = ad.get_inv_G(box, den, tm.WangTeter)
    assert float((G_wt - G_lind).abs().max()) < 1e-10


def test_kgap_reproduces_gapped_jellium():
    """Measured max |diff| 2.2e-13 off eta = 0 (bound 1e-10)."""
    box, den = _uniform()
    eta, G_kgap = ad.get_inv_G(box, den, lambda bv, n: tm.KGAP(bv, n, 1.17))
    _, G_gap = tm.G_inv_gap(box, den, 1.17)
    nz = eta != 0
    assert float((G_kgap - G_gap)[nz].abs().max()) < 1e-10


def test_yukawa_yuk1_closed_form():
    """The ladder term is prepared at the uniform density and evaluated on
    that ladder; measured max |diff| 2.6e-4 (bound 1e-3, the spline
    method's accuracy for second derivatives)."""
    box, den = _uniform()
    y = tm.YukawaGGA()
    y.mode = "arithmetic"
    y.kappa = 0.001
    y.set_yuk1()
    eta, G = ad.get_inv_G(box, den, y.forward)
    th = 1 / (3 * eta**2 + (-16 * eta**4 + 40 * eta**2 + 5)
              / (80 * eta**4 + 40 * eta**2 + 5))
    assert float((G - th).abs().max().detach()) < 1e-3


def _case(seed=3, n=12):
    """A primitive fcc cell [bohr] and a positive, non-uniform density."""
    box = 7.65 * np.array([[0.5, 0.5, 0.0], [0.0, 0.5, 0.5],
                           [0.5, 0.0, 0.5]])
    rng = np.random.default_rng(seed)
    den = 0.03 * (1.0 + 0.1 * rng.standard_normal((n, n, n)))
    return box, den


FUNCTIONALS = {
    "WangTeter": (jm.WangTeter, tm.WangTeter),
    "PBE": (jm.PerdewBurkeErnzerhof, tm.PerdewBurkeErnzerhof),
    "vWGTF1": (jm.vWGTF1, tm.vWGTF1),
}


@pytest.mark.parametrize("name", list(FUNCTIONALS))
def test_stress_and_pressure_match_jax(name):
    """get_stress and get_pressure at 12^3 f64, rtol 1e-10."""
    jf, tf = FUNCTIONALS[name]
    box, den = _case()
    s_j = jad.get_stress(jnp.asarray(box), jnp.asarray(den), jf)
    p_j = jad.get_pressure(jnp.asarray(box), jnp.asarray(den), jf)
    s = ad.get_stress(torch.tensor(box), torch.tensor(den), tf)
    p = ad.get_pressure(torch.tensor(box), torch.tensor(den), tf)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=1e-10,
                               atol=1e-10 * float(np.abs(s_j).max()))
    np.testing.assert_allclose(float(p), float(p_j), rtol=1e-10)


@pytest.mark.parametrize("name", ["WangTeter", "vWGTF1"])
def test_inv_G_matches_jax(name):
    """get_inv_G at 12^3 f64 (about the uniform density of the case's
    electron count), rtol 1e-10."""
    jf, tf = FUNCTIONALS[name]
    box, den = _case()
    eta_j, G_j = jad.get_inv_G(jnp.asarray(box), jnp.asarray(den), jf)
    eta, G = ad.get_inv_G(torch.tensor(box), torch.tensor(den), tf)
    np.testing.assert_allclose(eta.numpy(), np.asarray(eta_j), rtol=1e-12)
    np.testing.assert_allclose(G.numpy(), np.asarray(G_j), rtol=1e-10)
