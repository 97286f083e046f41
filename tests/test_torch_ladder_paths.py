"""The ladder terms (Huang-Carter, revHC, YukawaGGA) through the port's
density optimizer and against its own derivatives, f64 and f32 on the CPU:
HC's ``optimize_density(jit_loop=True, analytic=True)`` converged against
the autograd path (the case of ``tests/test_potentials.py``; its first
steps against the JAX package are in ``test_torch_hc_end_to_end.py``), the
directional derivatives and the f32 tier of
``tests/test_advanced_functional_derivatives.py``, and HC's stress against
the JAX package's.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from professad_tpu import models as jm
from professad_tpu_torch import System
from professad_tpu_torch import models as tm
from paths import pot

HC_ARGS = (0.45, 0.51, 1.2)


PRIM = 4.05 * np.array([[0.5, 0.5, 0.0], [0.0, 0.5, 0.5], [0.5, 0.0, 0.5]])


def _hc_system(terms, shape=(12, 12, 12)):
    return System(PRIM, shape, [["Al", pot("al.gga.recpot"),
                                 np.zeros((1, 3))]], terms, units="a",
                  coord_type="fractional", device="cpu")


def test_hc_converged_analytic_matches_autograd():
    """``optimize_density(jit_loop=True)`` with HC
    (``tests/test_potentials.py``'s end-to-end case) converged with the
    analytic and with the autograd gradient: the same plateau (1e-6 eV, the
    JAX test's bound).  Its first 8 steps are held against the JAX package
    in ``test_torch_hc_end_to_end.py``."""
    energies = []
    for analytic in (False, True):
        s = _hc_system([tm.IonIon, tm.IonElectron, tm.Hartree,
                        tm.HuangCarter(HC_ARGS).forward,
                        tm.PerdewBurkeErnzerhof])
        n_it, conv = s.optimize_density(
            analytic=analytic, ntol=1e-9, jit_loop=True, precondition=True,
            n_step_size=1.0, n_method="TPGD", skip_iters=2)
        assert conv
        energies.append(s.energy("eV"))
    assert abs(energies[0] - energies[1]) < 1e-6


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def test_hc_stress_matches_jax():
    """The stress differentiates the HC energy with respect to the cell on
    the prepared ladder (never the hoisted slabs, which depend on the
    cell): a system whose one term is HC, against the JAX package's
    ``System._compute_stress`` formula on the same term, jitted (its
    System's eager set-up alone takes about 10 s).  The ladder is the
    port's prepare on this density, carried to the JAX functional."""
    from professad_tpu.ops.grid import volume as jvolume
    jf, tf = jm.HuangCarter(HC_ARGS), tm.HuangCarter(HC_ARGS)
    shape = (10, 10, 10)
    ts = _hc_system([tf.forward], shape)
    den = 1.0 + 0.2 * np.random.default_rng(5).random(shape)
    den *= ts._N_elec / (den.mean() * ts.volume("b3"))
    ts.set_density(torch.tensor(den))
    ts._prepare_dynamic_kernels()
    jf.xi_sparse = tf.xi_sparse
    box0, vol0 = jnp.asarray(ts._box_vecs.numpy()), ts.volume("b3")
    ref = np.asarray(jax.jit(jax.grad(lambda h: jf.forward(
        h, jnp.asarray(den) * vol0 / jvolume(h))))(box0).T @ box0 / vol0)
    assert _rel(ts.stress().numpy(), 0.5 * (ref + ref.T)) < 1e-10


# -- directional derivatives and the f32 tier -------------------------------

def _smooth_density(shape=(16, 16, 16), seed=0, n_mean=0.03):
    rng = np.random.default_rng(seed)
    spec = np.zeros(shape, dtype=complex)
    spec[:3, :3, :3] = (rng.normal(size=(3, 3, 3))
                        + 1j * rng.normal(size=(3, 3, 3)))
    bumps = np.real(np.fft.ifftn(spec))
    return n_mean * (1.0 + 0.4 * bumps / np.max(np.abs(bumps)))


@pytest.fixture(scope="module")
def advanced():
    yk = tm.YukawaGGA()
    yk.set_yuk2()
    return {"HuangCarter": tm.HuangCarter((0.01177, 0.7143, 1.2)),
            "RevisedHuangCarter": tm.RevisedHuangCarter(
                (0.45, 0.10, 0.7143, 1.2)),
            "Yukawa-yuk2": yk}


@pytest.mark.parametrize("name", ["HuangCarter", "RevisedHuangCarter",
                                  "Yukawa-yuk2"])
def test_directional_derivative(advanced, name):
    """d/dt E(n + t u) at t = 0 against <dE/dn, u>, rtol 1e-6, on a smooth
    density (16^3, f64) in a zero-mean direction."""
    f = advanced[name]
    box = torch.tensor(7.7 * np.eye(3))
    den = torch.tensor(_smooth_density())
    u = torch.tensor(_smooth_density(seed=1, n_mean=1.0) - 1.0)
    u = u - u.mean()
    f.prepare(box, den)
    g = torch.func.grad(lambda d: f.forward_static(box, d))(den)
    ad = float(torch.sum(g * u).detach())
    eps = 1e-6
    with torch.no_grad():
        fd = float((f.forward_static(box, den + eps * u)
                    - f.forward_static(box, den - eps * u)) / (2 * eps))
    assert np.isclose(ad, fd, rtol=1e-6), (name, ad, fd)


@pytest.mark.parametrize("name", ["HuangCarter", "RevisedHuangCarter",
                                  "Yukawa-yuk2"])
def test_f32_tier_energy_and_gradient(advanced, name):
    """f32 against f64: energy within 5e-5 relative, gradient within 5e-3
    relative L2."""
    f = advanced[name]
    out = {}
    for dt in (torch.float64, torch.float32):
        box = torch.tensor(7.7 * np.eye(3), dtype=dt)
        den = torch.tensor(_smooth_density(), dtype=dt)
        f.prepare(box, den)
        E = float(f(box, den).detach())
        g = torch.func.grad(lambda d: f.forward_static(box, d))(den)
        out[dt] = (E, g.detach().double().numpy())
    (E64, g64), (E32, g32) = out[torch.float64], out[torch.float32]
    assert abs(E32 - E64) / abs(E64) < 5e-5, (name, E32, E64)
    assert np.linalg.norm(g32 - g64) / np.linalg.norm(g64) < 5e-3
