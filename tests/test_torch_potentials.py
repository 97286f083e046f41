"""The port's fused analytic potentials, chi gradient and preconditioner
kernel against the JAX package, f64 on the CPU at 16^3.

Inputs come from numpy with a seed and go through both packages; the
tolerance is the JAX suite's own f64 derivative-identity bound, rtol 1e-10.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from professad_tpu import system as jsys
from professad_tpu.models import potentials as jpot
from professad_tpu.models import (IonIon as jIonIon,
                                  IonElectron as jIonElectron,
                                  Hartree as jHartree,
                                  WangTeter as jWangTeter,
                                  PerdewBurkeErnzerhof as jPBE)
from professad_tpu_torch import system as tsys
from professad_tpu_torch.models import potentials as tpot
from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                        WangTeter, PerdewBurkeErnzerhof,
                                        ThomasFermi)
from paths import pot

SHAPE = (16, 16, 16)
RTOL = 1e-10
J_TERMS = [jIonIon, jIonElectron, jHartree, jWangTeter, jPBE]
T_TERMS = [IonIon, IonElectron, Hartree, WangTeter, PerdewBurkeErnzerhof]


@pytest.fixture(scope="module")
def state():
    rng = np.random.default_rng(5)
    box = 7.3 * np.eye(3) + 0.15 * rng.standard_normal((3, 3))
    den = 0.25 + 0.1 * rng.random(SHAPE)
    vext = 0.1 * rng.standard_normal(SHAPE)
    return box, den, vext


def _ctxs(box, den, vext):
    jc = jpot.SpectralCtx(jnp.asarray(box), jnp.asarray(den),
                          jnp.asarray(vext))
    tc = tpot.SpectralCtx(torch.tensor(box), torch.tensor(den),
                          torch.tensor(vext))
    return jc, tc


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) <= rtol * np.max(np.abs(b))


PIECES = {
    "ion_electron": lambda m, c: m._vp_ion_electron(c),
    "hartree": lambda m, c: m._vp_hartree(c),
    "thomas_fermi": lambda m, c: m._vp_thomas_fermi(c),
    "weizsaecker": lambda m, c: m._vp_weizsaecker(c),
    "nlkef": lambda m, c: m._vp_nlkef(c, 5.0 / 6.0, 5.0 / 6.0),
    "pw92": lambda m, c: m._pw92_eps_and_deriv(c.den),
    "pbe": lambda m, c: m._vp_pbe(c),
}


@pytest.mark.parametrize("piece", list(PIECES))
def test_vp_piece_matches_jax(state, piece):
    jc, tc = _ctxs(*state)
    ref = PIECES[piece](jpot, jc)
    out = PIECES[piece](tpot, tc)
    for o, r in zip(out, ref):
        assert o.dtype == torch.float64
        assert _close(o.numpy(), r), piece


def test_value_and_potential_matches_jax(state):
    box, den, vext = state
    E_ref, pot_ref = jpot.value_and_potential(
        J_TERMS, jnp.asarray(box), jnp.asarray(den), jnp.asarray(vext))
    E, p = tpot.value_and_potential(T_TERMS, torch.tensor(box),
                                    torch.tensor(den), torch.tensor(vext))
    assert abs(float(E) - float(E_ref)) <= RTOL * abs(float(E_ref))
    assert _close(p.numpy(), pot_ref)


def test_unported_terms_rejected(state):
    """A closure-wrapped XuWangMa carries a kappa the dispatcher cannot
    read: it is unsupported, as in the JAX package
    (``tests/test_potentials.py``), rather than silently wrong."""
    from professad_tpu.models import XuWangMa as jXuWangMa
    from professad_tpu_torch.models import XuWangMa
    box, den, vext = state

    def wrapped(box_vecs, den):
        return XuWangMa(box_vecs, den, 0.01)
    wrapped.__name__ = "XuWangMa"

    def jwrapped(box_vecs, den):
        return jXuWangMa(box_vecs, den, 0.01)
    jwrapped.__name__ = "XuWangMa"

    assert tpot.supported_terms(T_TERMS + [XuWangMa])
    assert not tpot.supported_terms(T_TERMS + [wrapped])
    assert not jpot.supported_terms(J_TERMS + [jwrapped])
    with pytest.raises(KeyError):
        tpot.value_and_potential([wrapped], torch.tensor(box),
                                 torch.tensor(den), torch.tensor(vext))


@pytest.fixture(scope="module")
def systems():
    """The bench system (4-atom cubic fcc Al, WT+PBE) at 16^3 in the port;
    on the JAX side the two methods under test need only the term list and
    the grid shape, so the (slow, eager) JAX setup is skipped."""
    frac = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0],
                     [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]])
    ts = tsys.System(4.05 * np.eye(3), SHAPE,
                     [["Al", pot("al.gga.recpot"), frac]], T_TERMS,
                     units="a", coord_type="fractional", device="cpu")
    js = jsys.System.__new__(jsys.System)
    js._terms, js._shape = list(J_TERMS), SHAPE
    return js, ts


def test_chi_value_and_grad_analytic_matches_jax(systems):
    js, ts = systems
    rng = np.random.default_rng(0)
    chi = 0.2 + 0.05 * rng.random(SHAPE)
    box, vext, N = ts._box_vecs, ts._v_ext, float(ts._N_elec)
    E_ref, g_ref = js._chi_value_and_grad_analytic(
        jnp.asarray(chi), jnp.asarray(box.numpy()), jnp.asarray(vext.numpy()),
        N)
    E, g = ts._chi_value_and_grad_analytic(torch.tensor(chi), box, vext, N)
    assert abs(float(E) - float(E_ref)) <= RTOL * abs(float(E_ref))
    assert _close(g.numpy(), g_ref)


def test_chi_gradient_matches_autograd_of_chi_energy(systems):
    """The fused analytic chi gradient equals torch.func.grad of the
    energy-only chain (_chi_energy), the identity the JAX suite checks
    with jax.grad."""
    _, ts = systems
    chi = torch.tensor(0.2 + 0.05 * np.random.default_rng(1).random(SHAPE))
    args = (ts._box_vecs, ts._v_ext, float(ts._N_elec))
    E_a, g_a = ts._chi_value_and_grad_analytic(chi, *args)
    g_d = torch.func.grad(lambda c: ts._chi_energy(c, *args))(chi)
    assert abs(float(E_a) - float(ts._chi_energy(chi, *args))) <= \
        1e-12 * abs(float(E_a))
    assert _close(g_a.numpy(), g_d.numpy())


def test_exact_precond_kernel_matches_jax(systems):
    js, ts = systems
    N = float(ts._N_elec)
    M_ref = jax.jit(js._exact_precond_kernel)(
        jnp.asarray(ts._box_vecs.numpy()), N)
    M = ts._exact_precond_kernel(ts._box_vecs, N)
    assert M.shape == (16, 16, 9) and M.dtype == torch.float64
    assert M.is_contiguous()  # the CUDA kernel takes contiguous K only
    assert _close(M.numpy(), M_ref)


def test_exact_precond_kernel_f32_is_finite_and_close(systems):
    """The f32 HVP (the main path's dtype) goes through torch.func with
    the DC-split transforms and the f64-combined means, and stays within
    f32 rounding of the f64 kernel."""
    _, ts = systems
    N = float(ts._N_elec)
    M64 = ts._exact_precond_kernel(ts._box_vecs, N).numpy()
    M32 = ts._exact_precond_kernel(ts._box_vecs.float(), N)
    assert M32.dtype == torch.float32
    assert np.all(np.isfinite(M32.numpy()))
    assert _close(M32.numpy(), M64, rtol=1e-4)


def test_thomas_fermi_energy_matches_its_potential(state):
    """Energy-only term against the fused piece: the autograd derivative
    of ThomasFermi equals the analytic TF potential (times the weight)."""
    box, den, _ = state
    b, d = torch.tensor(box), torch.tensor(den, requires_grad=True)
    E = ThomasFermi(b, d)
    E.backward()
    vol = float(torch.abs(torch.linalg.det(b)))
    _, p = tpot._vp_thomas_fermi(tpot.SpectralCtx(b, d.detach()))
    assert _close(d.grad.numpy() / (vol / d.numel()), p.numpy())
