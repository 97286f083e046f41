"""The port's kernel-table and Taylor-kernel non-local functionals (WGC99,
Foley-Madden, KGAP, XWM, MGP) against the JAX package, f64 on the CPU:
energies and fused potentials (rtol 1e-10, and against the port's own
autograd), MGP's line-integral table (rtol 1e-13), the chi gradient, the
rejections of ``supported_terms``, that no kernel which requires grad
reaches the spectral-convolution kernel, and the directional derivatives
and f32 tier of ``tests/test_advanced_functional_derivatives.py``.

Inputs come from numpy with a seed (the 14^3 random states of
``tests/test_potentials.py``) and go through both packages.
"""

from functools import partial

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from professad_tpu import models as jm
from professad_tpu import system as jsys
from professad_tpu.models import potentials as jpot
from professad_tpu_torch import System, functional_state_from_jax
from professad_tpu_torch import models as tm
from professad_tpu_torch.models import potentials as tpot
from professad_tpu_torch.ops import spectral_conv as sc
from professad_tpu_torch.ops.autodiff import get_functional_derivative

RTOL = 1e-10
MGP_ARGS = (0.2, 0.45)


def _state(shape=(14, 14, 14)):
    rng = np.random.default_rng(5)
    box = 7.3 * np.eye(3) + 0.15 * rng.standard_normal((3, 3))
    den = 0.25 + 0.1 * rng.random(shape)
    vext = 0.1 * rng.standard_normal(shape)
    return box, den, vext


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module")
def mgp():
    """(JAX, port) MGP prepared on the 14^3 state (each table integrated
    once), the JAX table carried into the port's."""
    box, den, _ = _state()
    jf, tf = jm.MiGenovaPavanello(MGP_ARGS), tm.MiGenovaPavanello(MGP_ARGS)
    jf.prepare(jnp.asarray(box), jnp.asarray(den))
    tf.prepare(torch.tensor(box), torch.tensor(den))
    own = tf.kernel
    tf.load_functional_state(functional_state_from_jax(jf, device="cpu"))
    return jf, tf, own


def _cases(mgp):
    """name -> (JAX term, port term), each term as a user passes it."""
    jf, tf, _ = mgp

    def jtanh(x):
        return 1.0 + x + 0.2 * jnp.tanh(x)

    def ttanh(x):
        return 1.0 + x + 0.2 * torch.tanh(x)
    return {
        "WGC99": (jm.WangGovindCarter99().forward,
                  tm.WangGovindCarter99().forward),
        "WGC99_params": (jm.WangGovindCarter99((0.9, 0.6, 2.2, 1.05)),
                         tm.WangGovindCarter99((0.9, 0.6, 2.2, 1.05))),
        "FoleyMadden": (jm.FoleyMadden(), tm.FoleyMadden()),
        "FoleyMadden_params": (jm.FoleyMadden((0.8, 0.9, lambda x: 1.0 + x)),
                               tm.FoleyMadden((0.8, 0.9, lambda x: 1.0 + x))),
        "KGAP": (partial(jm.KGAP, E_gap=1.17), partial(tm.KGAP, E_gap=1.17)),
        "KGAP_tanh": (partial(jm.KGAP, E_gap=3.0, f=jtanh),
                      partial(tm.KGAP, E_gap=3.0, f=ttanh)),
        "XWM": (jm.XuWangMa, tm.XuWangMa),
        "XWM_kappa": (partial(jm.XuWangMa, kappa=0.01),
                      partial(tm.XuWangMa, kappa=0.01)),
        "MGP": (jf.forward, tf.forward),
    }


CASES = ["WGC99", "WGC99_params", "FoleyMadden", "FoleyMadden_params",
         "KGAP", "KGAP_tanh", "XWM", "XWM_kappa", "MGP"]


@pytest.mark.parametrize("name", CASES)
def test_energy_and_potential_match_jax(mgp, name):
    """The direct energy and the fused potential against the JAX package's
    fused sweep (whose energy equals its direct one at 1e-12,
    ``tests/test_potentials.py``), and the port's own autograd."""
    jt, tt = _cases(mgp)[name]
    box, den, vext = _state()
    assert tpot.supported_terms([tt])
    E_j, p_j = jax.jit(lambda b, d, v: jpot.value_and_potential(
        [jt], b, d, v))(*map(jnp.asarray, (box, den, vext)))
    tb, td, tv = map(torch.tensor, (box, den, vext))
    E_ref = float(E_j)
    with torch.no_grad():
        assert abs(float(tt(tb, td)) - E_ref) <= RTOL * abs(E_ref)
    E_t, p_t = tpot.value_and_potential([tt], tb, td, tv)
    assert p_t.dtype == torch.float64 and not p_t.requires_grad
    assert abs(float(E_t) - E_ref) <= RTOL * abs(E_ref)
    assert _rel(p_t.numpy(), p_j) < RTOL
    g = get_functional_derivative(tb, td, tt)
    assert _rel(p_t.numpy(), g.detach().numpy()) < RTOL


def test_mgp_table_matches_jax(mgp):
    """The port's own table (integrated in row blocks) against the JAX
    package's, and the hoisted k-space kernel."""
    jf, tf, own = mgp
    for a, b in zip(own, jf.kernel):
        assert a.shape == b.shape
        assert _rel(a.numpy(), b) < 1e-13
    assert _rel(tf.aux_arrays()["kernel"].numpy(),
                jf.aux_arrays()["kernel"]) < 1e-13


def test_chi_gradient_matches_jax(mgp):
    """The analytic and the autograd chi gradient over WGC99, KGAP and MGP
    (the autograd one on MGP's hoisted kernel) against the JAX package's
    analytic one."""
    cases = _cases(mgp)
    names = ["WGC99", "KGAP", "MGP"]
    js = jsys.System.__new__(jsys.System)
    js._terms = [jm.Hartree] + [cases[n][0] for n in names]
    ts = System.__new__(System)
    ts._terms = [tm.Hartree] + [cases[n][1] for n in names]
    box, den, vext = _state()
    js._shape = ts._shape = den.shape
    chi = np.sqrt(den) * (1.0 + 0.05 * np.random.default_rng(0).random(
        den.shape))
    N = float(np.mean(den) * abs(np.linalg.det(box)))
    E_ref, g_ref = jax.jit(js._chi_value_and_grad_analytic)(
        jnp.asarray(chi), jnp.asarray(box), jnp.asarray(vext), N)
    aux = ts._collect_term_aux()
    assert [a is None for a in aux] == [True, True, True, False]
    args = (torch.tensor(chi), torch.tensor(box), torch.tensor(vext), N, aux)
    for E, g in (ts._chi_value_and_grad_analytic(*args),
                 ts._chi_value_and_grad(*args)):
        assert abs(float(E) - float(E_ref)) <= RTOL * abs(float(E_ref))
        assert _rel(g.numpy(), np.asarray(g_ref).reshape(den.shape)) < RTOL


def test_no_kernel_that_requires_grad_reaches_spectral_conv(mgp, monkeypatch):
    """The card's kernel computes no dK, so every call site must hand it
    a constant kernel: the fused sweep of each non-local term, the trainable
    ones with parameters that require grad."""
    seen = []
    kernel = sc.spectral_conv

    def watched(x, K):
        seen.append(K.requires_grad)
        return kernel(x, K)
    monkeypatch.setattr(sc, "spectral_conv", watched)
    yuk = tm.YukawaGGA()
    yuk.set_yuk4()
    terms = [t for _, t in _cases(mgp).values()] + [
        tm.HuangCarter((0.45, 0.51, 1.2)).forward,
        tm.RevisedHuangCarter((0.65, 0.2, 0.55, 1.15)).forward, yuk.forward]
    box, den, vext = map(torch.tensor, _state((10, 10, 10)))
    for t in terms:
        owner = getattr(t, "__self__", t)
        if isinstance(owner, torch.nn.Module):
            owner.param_grad(True)
            if hasattr(owner, "prepare"):
                owner.prepare(box, den)
        before = len(seen)
        tpot.value_and_potential([t], box, den, vext)
        assert len(seen) > before
    assert not any(seen)


def test_rejections():
    """What ``supported_terms`` refuses, as the JAX package does: a
    closure-wrapped XWM (its kappa cannot be read), a positional partial
    (it would shift the cell and density arguments), a KGAP partial
    without E_gap."""
    def wrapped(bv, d):
        return tm.XuWangMa(bv, d, 0.01)
    wrapped.__name__ = "XuWangMa"
    for t in (wrapped, partial(tm.XuWangMa, 0.01), partial(tm.KGAP, 1.17),
              partial(tm.KGAP, f=lambda x: 1.0 + x)):
        assert not tpot.supported_terms([t])
    assert tpot.supported_terms([tm.XuWangMa, partial(tm.KGAP, E_gap=0.5)])
    box, den, vext = map(torch.tensor, _state((6, 6, 6)))
    with pytest.raises(KeyError):
        tpot.value_and_potential([wrapped], box, den, vext)


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
    """The functionals and parameters of
    ``tests/test_advanced_functional_derivatives.py``."""
    return {"WGC99": tm.WangGovindCarter99(), "FoleyMadden": tm.FoleyMadden(),
            "KGAP": lambda b, d: tm.KGAP(b, d, 1.17),
            "MGP": tm.MiGenovaPavanello((0.2, 0.1)),
            "XWM": lambda b, d: tm.XuWangMa(b, d, 0.01)}


def _prepare(f, box, den):
    if hasattr(f, "prepare"):
        f.prepare(box, den)


@pytest.mark.parametrize("name", ["WGC99", "FoleyMadden", "KGAP", "MGP",
                                  "XWM"])
def test_directional_derivative(advanced, name):
    """d/dt E(n + t u) at t = 0 against <dE/dn, u>, rtol 1e-6, on a smooth
    density (16^3, f64) in a zero-mean direction."""
    f = advanced[name]
    box = torch.tensor(7.7 * np.eye(3))
    den = torch.tensor(_smooth_density())
    u = torch.tensor(_smooth_density(seed=1, n_mean=1.0) - 1.0)
    u = u - u.mean()
    _prepare(f, box, den)
    g = torch.func.grad(lambda d: f(box, d))(den)
    ad = float(torch.sum(g * u).detach())
    eps = 1e-6
    with torch.no_grad():
        fd = float((f(box, den + eps * u) - f(box, den - eps * u))
                   / (2 * eps))
    assert np.isclose(ad, fd, rtol=1e-6), (name, ad, fd)


@pytest.mark.parametrize("name", ["WGC99", "FoleyMadden", "KGAP", "MGP",
                                  "XWM"])
def test_f32_tier_energy_and_gradient(advanced, name):
    """f32 against f64: energy within 5e-5 relative, gradient within 5e-3
    relative L2."""
    f = advanced[name]
    out = {}
    for dt in (torch.float64, torch.float32):
        box = torch.tensor(7.7 * np.eye(3), dtype=dt)
        den = torch.tensor(_smooth_density(), dtype=dt)
        _prepare(f, box, den)
        g = torch.func.grad(lambda d: f(box, d))(den)
        with torch.no_grad():
            out[dt] = (float(f(box, den)), g.detach().double().numpy())
    (E64, g64), (E32, g32) = out[torch.float64], out[torch.float32]
    assert abs(E32 - E64) / abs(E64) < 5e-5, (name, E32, E64)
    assert np.linalg.norm(g32 - g64) / np.linalg.norm(g64) < 5e-3
