"""Ground-state properties differentiable with respect to a trainable
functional's parameters (``System.gs_property_fn``,
``gs_volume_property_fn``), in f64 on the CPU.

``gs_property_fn``: fcc Al with Pauli-Gaussian (all four parameters
nonzero) + PBE at 6^3, the density converged by the JAX package and
carried across; the gradients of the ground-state energy and of a
density-matching loss against a dense implicit-function-theorem reference
from the JAX package's energy E(chi, params) (its Hessian by a jitted
Hessian-vector product on every unit vector; d chi* = -P H^+ P b dparams,
H^+ by ``lstsq`` on the chi block projected off chi^), rtol 1e-8: the
port's adjoint solve follows the same chain.

``gs_volume_property_fn``: the pressure and bulk modulus and their
gradients in mu against central finite differences of the port's own
re-optimized ground states at 8^3, at the bounds of
``tests/test_gs_training.py``; then the validation errors."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from professad_tpu import system as jsys
from professad_tpu.models import (IonIon as jIonIon,
                                  IonElectron as jIonElectron,
                                  Hartree as jHartree,
                                  PauliGaussian as jPauliGaussian,
                                  PerdewBurkeErnzerhof as jPBE)
from professad_tpu.ops.grid import wmean as jwmean, volume as jvolume
from professad_tpu_torch import System, system_state_from_jax
from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                        PauliGaussian, PerdewBurkeErnzerhof)
from paths import pot

BOX = 4.05 * np.array([[0.5, 0.5, 0.0], [0.0, 0.5, 0.5], [0.5, 0.0, 0.5]])
PARAMS = (40.0 / 27.0, 0.25, 0.4, 0.2)    # mu, beta, lamb, sigma: PGSLr
KEYS = ("mu", "beta", "lamb", "sigma")


def _port(pg, shape):
    return System(BOX, shape, [["Al", pot("al.gga.recpot"), np.zeros((1, 3))]],
                  [IonIon, IonElectron, Hartree, pg, PerdewBurkeErnzerhof],
                  units="a", coord_type="fractional", device="cpu")


@pytest.fixture(scope="module")
def pair():
    jpg = jPauliGaussian(PARAMS)
    js = jsys.System(jnp.asarray(BOX), (6, 6, 6),
                     [["Al", pot("al.gga.recpot"), jnp.zeros((1, 3))]],
                     [jIonIon, jIonElectron, jHartree, jpg, jPBE],
                     units="a", coord_type="fractional")
    js.optimize_density(ntol=1e-10)
    pg = PauliGaussian(PARAMS)
    ts = _port(pg, (6, 6, 6))
    ts.load_state_dict(system_state_from_jax(js.state_dict(), device="cpu"))
    return js, jpg, ts, pg


def _dense_dchi(js, jpg):
    """(chi0, d chi*/d params (n, 4)) from the JAX energy E(chi, params)."""
    box, v_ext, N = js._box_vecs, js._v_ext, js._N_elec
    chi = jnp.sqrt(js._den)
    n = chi.size
    z0 = jnp.concatenate([chi.ravel(),
                          jnp.asarray([jpg.params[k] for k in KEYS])])

    def energy(z):
        c = z[:n].reshape(chi.shape)
        den = (N / (jwmean(c * c) * jvolume(box))) * c * c
        E = 0.0
        for f in js._terms:
            if f is jpg:
                E = E + jpg.apply(dict(zip(KEYS, z[n:])), box, den)
            elif f is jIonElectron:
                E = E + f(box, den, v_ext)
            elif f is not jIonIon:
                E = E + f(box, den)
        return E
    jvp = jax.jit(lambda v: jax.jvp(jax.grad(energy), (z0,), (v,)))
    cols = [jvp(e) for e in jnp.eye(z0.size)]
    g = np.asarray(cols[0][0])
    Hz = np.stack([np.asarray(c[1]) for c in cols])
    H, B = Hz[:n, :n], Hz[:n, n:]
    ch = np.asarray(chi).ravel() / np.linalg.norm(np.asarray(chi))
    P = np.eye(n) - np.outer(ch, ch)
    dchi = -P @ np.linalg.lstsq(P @ H @ P, P @ B, rcond=None)[0]
    return np.asarray(chi), g, dchi


def test_gs_property_fn_grads_match_dense_ift(pair):
    js, jpg, ts, pg = pair
    chi0, g, dchi = _dense_dchi(js, jpg)
    n = chi0.size
    fn = ts.gs_property_fn(pg)
    E = fn(pg.params)
    assert float(E) == pytest.approx(ts.energy(), rel=1e-12)
    grads = torch.autograd.grad(E, [pg.params[k] for k in KEYS])
    ref = g[n:] + g[:n] @ dchi              # dE/dp + grad_chi E . dchi/dp
    got = np.array([float(t) for t in grads])
    assert np.max(np.abs(got - ref)) <= 1e-8 * np.max(np.abs(ref))

    # a density-matching loss L = mean((n(chi) - target)^2)
    target = torch.as_tensor(np.asarray(js._den) * 1.02)
    fn = ts.gs_property_fn(
        pg, property_fn=lambda den, E: torch.mean((den - target) ** 2))
    grads = torch.autograd.grad(fn(pg.params), [pg.params[k] for k in KEYS])
    N, vol = js._N_elec, js.volume("b3")

    def loss(c):
        den = (N / (jnp.mean(c * c) * vol)) * c * c
        return jnp.mean((den - jnp.asarray(target.numpy())) ** 2)
    dL = np.asarray(jax.grad(loss)(jnp.asarray(chi0))).ravel()
    ref = dL @ dchi
    got = np.array([float(t) for t in grads])
    assert np.max(np.abs(got - ref)) <= 1e-8 * np.max(np.abs(ref))


def _ground_state(mu, shape=(8, 8, 8)):
    pg = PauliGaussian((mu,) + PARAMS[1:])
    s = _port(pg, shape)
    s.optimize_density(ntol=1e-11, n_maxiter=400)
    return s, pg


def test_gs_volume_property_fn_grads_vs_fd():
    """P and K and their mu-gradients (third mixed derivative for K,
    through the Newton map) against central differences of re-optimized
    ground states; the bounds of tests/test_gs_training.py."""
    s, pg = _ground_state(PARAMS[0])
    fn_P = s.gs_volume_property_fn(pg, property="pressure")
    fn_K = s.gs_volume_property_fn(pg, property="bulk_modulus")
    P0, K0 = fn_P(pg.params), fn_K(pg.params)
    assert np.isclose(float(P0), s.pressure(), rtol=1e-4, atol=1e-8)
    assert np.isclose(float(K0), s.bulk_modulus(), rtol=1e-4, atol=1e-8)
    (gP,) = torch.autograd.grad(P0, pg.params["mu"])
    (gK,) = torch.autograd.grad(K0, pg.params["mu"])

    eps = 3e-4
    sp, _ = _ground_state(PARAMS[0] + eps)
    sm, _ = _ground_state(PARAMS[0] - eps)
    fd_P = (sp.pressure() - sm.pressure()) / (2.0 * eps)
    fd_K = (sp.bulk_modulus() - sm.bulk_modulus()) / (2.0 * eps)
    assert np.isclose(float(gP), fd_P, rtol=3e-2, atol=1e-10), (gP, fd_P)
    assert np.isclose(float(gK), fd_K, rtol=3e-2, atol=1e-9), (gK, fd_K)


def test_validation_errors(pair):
    _, _, ts, pg = pair
    with pytest.raises(ValueError):
        ts.gs_volume_property_fn(pg, property="entropy")
    with pytest.raises(ValueError):
        ts.gs_volume_property_fn(PauliGaussian())
    with pytest.raises(ValueError):
        ts.gs_property_fn(PauliGaussian())
