"""Non-local kinetic energy functionals: the Lindhard response, the
Wang-Teter family (WT, Perrot, SM, WGC98 and the trainable WT-style
template), WGC99 (density-dependent kernel by an analytic series),
Foley-Madden (quadratic response), KGAP (gapped jellium), Huang-Carter and
revHC (density-dependent kernel from an ODE, by the xi-ladder spline
method), MGP and XWM (line-integral kernels).

PyTorch port of ``professad_tpu/models/kinetic_nonlocal.py``.  Masked
singular expressions keep the double-``where`` idiom so gradients stay
NaN-free.  The energy bodies convolve through ``torch.fft``, never the
spectral-convolution kernel, so they are differentiable with respect to
the cell.  Kernel tables (the HC ODE solution, the MGP line integral) are
built once per instance on the host in numpy, in float64, as in the JAX
package.

The ladder terms (HC, revHC) and MGP take per-cell state from
``prepare(box_vecs, den)``: the static xi ladder and the hoisted kernel
(``aux_arrays()``), built without a graph.  Where the JAX package decides
by tracing which one a call uses, the port decides by its arguments: a
direct call sizes the ladder from the density it is given;
``forward_static`` uses the cached ladder (the form ``System``
differentiates: the stress, the functional derivative, the autograd chi
gradient); ``apply_aux`` also uses the hoisted slabs (the density
optimizer paths only: the slabs depend on the cell, so a path that
differentiates with respect to the cell must not take them).
"""

import functools

import numpy as np
import torch

from ..ops.grid import (wavevecs, volume, safe_sqrt, grad_dot_grad, qmean,
                        wmean, reduced_gradient_squared, rfftn, irfftn)
from ..ops.interp import interpolate, interpolate_kernel
from ..ops.fieldconv import (field_dependent_convolution, ladder_convolution,
                             xi_ladder)
from ..utils.constants import EV_PER_HA
from .base import KineticFunctional
from .kinetic_local import (ThomasFermi, Weizsaecker, TF_COEFF,
                            _mean_density, _static_ladder)

__all__ = ["G_inv_lind_analytical", "G_inv_lind", "G_inv_lindhard",
           "non_local_KEF", "WangTeter", "Perrot", "SmargiassiMadden",
           "WangGovindCarter98", "WangTeterStyleFunctional",
           "WangGovindCarter99", "FoleyMadden", "G_inv_gap", "KGAP",
           "HuangCarter", "RevisedHuangCarter", "MiGenovaPavanello",
           "XuWangMa"]


def G_inv_lind_analytical(eta):
    """G^{-1}_Lindhard(eta); removable singularities NOT patched."""
    return (0.5 + ((1.0 - eta * eta) / (4.0 * eta))
            * torch.log(torch.abs((1.0 + eta) / (1.0 - eta))))


def G_inv_lind(eta):
    """Lindhard inverse response with eta=0 -> 1 and eta=1 -> 1/2 patched.

    For eta > 10 the closed form cancels catastrophically (fatal in f32),
    so the exact large-eta series sum_k u^k / ((2k-1)(2k+1)), u = eta^-2,
    truncated at k=8, takes over (error < 1e-18 at the switch)."""
    singular = (eta == 0.0) | (eta == 1.0)
    eta_safe = torch.where(singular, 0.5, eta)
    val = G_inv_lind_analytical(eta_safe)
    u = 1.0 / torch.where(eta > 10.0, eta, 10.0) ** 2
    series = u * (1 / 3 + u * (1 / 15 + u * (1 / 35 + u * (1 / 63 + u * (
        1 / 99 + u * (1 / 143 + u * (1 / 195 + u / 255)))))))
    val = torch.where(eta > 10.0, series, val)
    val = torch.where(eta == 0.0, 1.0, val)
    val = torch.where(eta == 1.0, 0.5, val)
    return val


def G_inv_lindhard(box_vecs, den):
    """(eta, G^{-1}(eta)) about the mean density; the electron number is
    detached so the response is density-independent."""
    _, _, _, k2 = wavevecs(box_vecs, den.shape)
    vol = volume(box_vecs)
    N_elec = (wmean(den) * vol).detach()
    n0 = N_elec / vol
    k_F = (3.0 * np.pi**2 * n0) ** (1.0 / 3.0)
    eta = safe_sqrt(k2) / (2.0 * k_F)
    return eta, G_inv_lind(eta)


def non_local_KEF(box_vecs, den, alpha, beta):
    """Wang-Teter-style non-local term: one FFT convolution of
    delta n^beta against the Lindhard-correction kernel."""
    vol = volume(box_vecs)
    N_elec = (wmean(den) * vol).detach()
    n0 = N_elec / vol
    eta, G_inv = G_inv_lindhard(box_vecs, den)
    kernel = (5.0 / (9.0 * alpha * beta * n0 ** (alpha + beta - 5.0 / 3.0))
              * (1.0 / G_inv - 3.0 * eta * eta - 1.0))
    conv = irfftn(kernel * rfftn(den ** beta - n0 ** beta), den.shape)
    return TF_COEFF * qmean((den ** alpha - n0 ** alpha) * conv) * vol


def WangTeter(box_vecs, den):
    """WT: (alpha, beta) = (5/6, 5/6)."""
    return (Weizsaecker(box_vecs, den) + ThomasFermi(box_vecs, den)
            + non_local_KEF(box_vecs, den, 5.0 / 6.0, 5.0 / 6.0))


def Perrot(box_vecs, den):
    """Perrot: (alpha, beta) = (1, 1)."""
    return (Weizsaecker(box_vecs, den) + ThomasFermi(box_vecs, den)
            + non_local_KEF(box_vecs, den, 1.0, 1.0))


def SmargiassiMadden(box_vecs, den):
    """SM: (alpha, beta) = (1/2, 1/2)."""
    return (Weizsaecker(box_vecs, den) + ThomasFermi(box_vecs, den)
            + non_local_KEF(box_vecs, den, 0.5, 0.5))


WGC98_ALPHA = float(5.0 + np.sqrt(5.0)) / 6.0
WGC98_BETA = float(5.0 - np.sqrt(5.0)) / 6.0


def WangGovindCarter98(box_vecs, den):
    """WGC98: (alpha, beta) = ((5 + sqrt 5)/6, (5 - sqrt 5)/6)."""
    return (Weizsaecker(box_vecs, den) + ThomasFermi(box_vecs, den)
            + non_local_KEF(box_vecs, den, WGC98_ALPHA, WGC98_BETA))


def _stabilizer_fprime0(f, name, unit_slope=False):
    """f'(0) of a stabilizer, after checking f(0) = 1 (and f'(0) = 1 where
    the functional requires it)."""
    zero = torch.zeros((), dtype=torch.float64)
    if float(f(zero)) != 1.0:
        raise ValueError(f"{name} requires f(0) = 1")
    fprime0 = float(torch.func.grad(f)(zero))
    if unit_slope and fprime0 != 1.0:
        raise ValueError(f"{name} requires f'(0) = 1")
    return fprime0


class WangTeterStyleFunctional(KineticFunctional):
    """WT-style functional with tunable (alpha, beta) and a Pauli-positivity
    stabilizer f with f(0) = 1: E = vW + TF f(T_NL / (f'(0) TF)).

    ``init_args = (alpha, beta, f)``; ``f`` is a torch callable on 0-d
    tensors (e.g. ``torch.exp``; default ``1 + x``).  A JAX functional's
    stabilizer is a callable on JAX arrays and is not carried across: pass
    its torch counterpart here and the parameters through
    ``load_params(convert.functional_params_from_jax(...))``."""

    def __init__(self, init_args=None):
        super().__init__(init_args)
        if init_args is None:
            alpha, beta, f = 5.0 / 6.0, 5.0 / 6.0, (lambda x: 1.0 + x)
        else:
            alpha, beta, f = init_args
        self._init_params(dict(alpha=alpha, beta=beta))
        self.f = f
        self.fprime0 = _stabilizer_fprime0(f, "WangTeterStyleFunctional")

    def apply(self, params, box_vecs, den):
        vW = Weizsaecker(box_vecs, den)
        TF = ThomasFermi(box_vecs, den)
        T_NL = non_local_KEF(box_vecs, den, params["alpha"],
                             params["beta"]) / self.fprime0
        return vW + TF * self.f(T_NL / TF)


# ------------------------- Wang-Govind-Carter 99 -------------------------

def _wgc99_Ai(num_terms):
    """Recursion coefficients A_i of the WGC99 kernel series."""
    ai = np.zeros(num_terms + 1)
    for index in range(num_terms + 1):
        i = index - 1
        if i == -1:
            ai[index] = 3.0
        else:
            for j in range(-1, i):
                ai[index] += -3.0 * ai[j + 1] / (4.0 * (i - j + 1) ** 2 - 1.0)
    Ai = np.empty(num_terms)
    Ai[0] = ai[1] - 1.0
    Ai[1:] = ai[2:]
    return Ai


def _wgc99_Bi(num_terms):
    """Recursion coefficients B_i of the WGC99 kernel series."""
    bi = np.zeros(num_terms)
    for i in range(num_terms):
        if i == 0:
            bi[i] = 1.0
        else:
            for j in range(i):
                bi[i] += bi[j] / (4.0 * (i - j) ** 2 - 1.0)
    Bi = np.empty(num_terms)
    Bi[0] = 0.0
    Bi[1] = bi[1] - 3.0
    Bi[2:] = bi[2:]
    return Bi


def _horner(coeffs, t):
    """sum_i coeffs[i] t**i elementwise by Horner's scheme (``coeffs`` a
    numpy vector): O(1) memory over the series."""
    acc = torch.zeros_like(t) + coeffs[-1]
    for c in coeffs[-2::-1]:
        acc = acc * t + c
    return acc


def _wgc99_kernel(eta, alpha, beta, gamma, num_terms=100):
    """WGC99 kernel (w0, w1, w2)(eta): homogeneous + particular ODE
    solutions in three regimes by the sign of v.  ``alpha, beta, gamma``
    are floats."""
    alpha = float(alpha); beta = float(beta); gamma = float(gamma)
    u = 3.0 * (alpha + beta) - gamma / 2.0
    v = u * u - 36.0 * alpha * beta

    Ai = _wgc99_Ai(num_terms)
    Bi = _wgc99_Bi(num_terms)
    i = np.arange(num_terms, dtype=np.float64)
    auxB = Bi / ((u - 2.0 * i) ** 2 - v)
    auxA = Ai / ((u + 2.0 * i) ** 2 - v)

    Sd = float(np.sum(auxA - auxB))
    Ss = float(-2.0 * np.sum(i * (auxA + auxB)))

    if v > 0:
        c1 = float(np.sign(u) * ((np.sqrt(v) - u) * Sd + Ss))
        c2 = float(np.sign(u) * ((np.sqrt(v) + u) * Sd - Ss)
                   / (2.0 * np.sqrt(v)))
    elif v == 0:
        c1 = float(np.sign(u) * Sd)
        c2 = float(np.sign(u) * (Ss - u * Sd))
    else:
        c1 = float(np.sign(u) * Sd)
        c2 = float(np.sign(u) * (Ss - u * Sd) / np.sqrt(-v))

    leq1 = eta <= 1.0
    C1 = torch.where(leq1, torch.full_like(eta, c1 if u >= 0 else 0.0),
                     torch.full_like(eta, 0.0 if u >= 0 else c1))
    C2 = torch.where(leq1, torch.full_like(eta, c2 if u >= 0 else 0.0),
                     torch.full_like(eta, 0.0 if u >= 0 else c2))

    nz = eta != 0.0
    e = torch.where(nz, eta, 1.0)  # singularity-safe eta

    # homogeneous solution
    if v > 0:
        x = float(u + np.sqrt(v))
        y = float(u - np.sqrt(v))
        H0 = C1 * e**x + C2 * e**y
        H1 = C1 * x * e**(x - 1) + C2 * y * e**(y - 1)
        H2 = C1 * x * (x - 1) * e**(x - 2) + C2 * y * (y - 1) * e**(y - 2)
    elif v == 0:
        ln = torch.log(e)
        H0 = e**u * (C2 * ln + C1)
        H1 = C2 * e**(u - 1) * (1 + u * ln) + C1 * u * e**(u - 1)
        H2 = (C2 * ((u - 1) * e**(u - 2) * (1 + u * ln) + e**(u - 2))
              + C1 * u * (u - 1) * e**(u - 2))
    else:
        sqrtv = float(np.sqrt(-v))
        ln = torch.log(e)
        tc = torch.cos(sqrtv * ln)
        ts = torch.sin(sqrtv * ln)
        H0 = e**u * (C1 * tc + C2 * ts)
        H1 = e**(u - 1) * (C1 * (u * tc - sqrtv * ts)
                           + C2 * (u * ts + sqrtv * tc))
        H2 = ((u - 1) * e**(u - 2) * C1 * (u * tc - sqrtv * ts)
              - sqrtv * e**(u - 2) * C1 * (u * ts + sqrtv * tc)
              + (u - 1) * e**(u - 2) * C2 * (u * ts + sqrtv * tc)
              + sqrtv * e**(u - 2) * C2 * (u * tc - sqrtv * ts))
    H0 = torch.where(nz, H0, 0.0)
    H1 = torch.where(nz, H1, 0.0)
    H2 = torch.where(nz, H2, 0.0)

    # particular solution: Horner polynomials in eta^2 (inside) and
    # eta^-2 (outside)
    t_in = e * e
    P0_in = _horner(auxB, t_in)
    P1_in = _horner(auxB * 2.0 * i, t_in) / e
    P2_in = _horner(auxB * 2.0 * i * (2.0 * i - 1.0), t_in) / (e * e)

    t_out = 1.0 / t_in
    P0_out = _horner(auxA, t_out)
    P1_out = -_horner(auxA * 2.0 * i, t_out) / e
    P2_out = _horner(auxA * 2.0 * i * (2.0 * i + 1.0), t_out) / (e * e)

    inside = leq1 & nz
    P0 = torch.where(inside, P0_in, torch.where(nz, P0_out, 0.0))
    P1 = torch.where(inside, P1_in, torch.where(nz, P1_out, 0.0))
    P2 = torch.where(inside, P2_in, torch.where(nz, P2_out, 0.0))

    return H0 + P0, H1 + P1, H2 + P2


class WangGovindCarter99(KineticFunctional):
    """WGC99: density-dependent kernel handled by a second-order Taylor
    expansion about the reference density kappa n0.  ``init_args =
    (alpha, beta, gamma, kappa)``, default ((5 + sqrt 5)/6, (5 - sqrt 5)/6,
    2.7, 1).  The kernel series reads alpha, beta, gamma as floats, so the
    parameters' gradients come only through the explicit factors."""

    def __init__(self, init_args=None):
        super().__init__(init_args)
        if init_args is None:
            alpha, beta, gamma, kappa = WGC98_ALPHA, WGC98_BETA, 2.7, 1.0
        else:
            alpha, beta, gamma, kappa = init_args
        self._init_params(dict(alpha=alpha, beta=beta, gamma=gamma,
                               kappa=kappa))
        self.num_terms = 100

    def apply(self, params, box_vecs, den):
        vol = volume(box_vecs)
        _, _, _, k2 = wavevecs(box_vecs, den.shape)
        n_ref = params["kappa"] * _mean_density(box_vecs, den)

        k_F = (3.0 * np.pi**2 * n_ref) ** (1.0 / 3.0)
        eta = safe_sqrt(k2) / (2.0 * k_F)

        alpha, beta, gamma = params["alpha"], params["beta"], params["gamma"]
        w0, w1, w2 = _wgc99_kernel(eta, float(alpha.detach()),
                                   float(beta.detach()),
                                   float(gamma.detach()), self.num_terms)
        T = 20.0 * n_ref ** (5.0 / 3.0 - alpha - beta)
        w0 = T * w0; w1 = T * w1; w2 = T * w2
        K1 = -eta * w1 / (6.0 * n_ref)
        K2 = (eta * eta * w2 + (7.0 - gamma) * eta * w1) / (36.0 * n_ref**2)
        K3 = (eta * eta * w2 + (1.0 + gamma) * eta * w1) / (36.0 * n_ref**2)

        theta = den - n_ref
        nb = den ** beta
        shape = den.shape

        def conv_with(kern, field):
            return irfftn(kern * rfftn(field), shape)

        conv = (conv_with(w0, nb)
                + theta * conv_with(K1, nb)
                + conv_with(K1, nb * theta)
                + 0.5 * theta**2 * conv_with(K2, nb)
                + conv_with(K2, 0.5 * nb * theta**2)
                + theta * conv_with(K3, nb * theta))

        T_NL = TF_COEFF * qmean(den ** alpha * conv) * vol
        return Weizsaecker(box_vecs, den) + ThomasFermi(box_vecs, den) + T_NL


# ------------------------------ Foley-Madden ------------------------------

class FoleyMadden(KineticFunctional):
    """Foley-Madden: the quadratic response of the HEG on top of the
    WT-style linear-response term.  ``init_args = (alpha, beta, f)``,
    default (5/6, 1, 1 + x); ``f`` is a torch callable with f(0) = 1 and
    f'(0) = 1."""

    def __init__(self, init_args=None):
        super().__init__(init_args)
        if init_args is None:
            alpha, beta, f = 5.0 / 6.0, 1.0, (lambda x: 1.0 + x)
        else:
            alpha, beta, f = init_args
        self._init_params(dict(alpha=alpha, beta=beta))
        self.f = f
        _stabilizer_fprime0(f, "FoleyMadden", unit_slope=True)

    @staticmethod
    def _piecewise_fits(q):
        """The seven fitted response functions f1..f7."""
        lo = q <= 1.95
        q_lo = torch.where(lo, q, 1.0)
        q_hi = torch.where(lo, 3.0, q)
        f1 = torch.where(
            lo, 0.4 * q_lo**2 / (1.0 + (q_lo / 2.33) ** 10),
            0.06 / (q_hi - 1.835) ** 0.75
            + 0.05 * (q_hi - 1.8) * torch.exp(-2.5 * (q_hi - 2.0)) + 1.0)

        # f2(q) == G_inv_lind(q/2) exactly (same patched limits at q=0, 2),
        # so it inherits the cancellation-safe large-eta series
        f2 = G_inv_lind(0.5 * q)

        lo = q <= 1.84
        q_lo = torch.where(lo, q, 1.0)
        q_hi = torch.where(lo, 3.0, q)
        f3 = torch.where(
            lo, (-q_lo**2 / 81.0 - 0.002 * q_lo**4)
            / (1.0 + (q_lo / 1.955) ** 28),
            -0.055 * torch.exp(-4.2 * (q_hi - 1.84)))

        f4 = torch.where(q <= 2.0, 1.0,
                         torch.exp(-3.0 * (torch.clamp(q, min=2.0) - 2.0)))

        f5 = torch.where(q <= 2.15,
                         0.02 * torch.exp(-30.0 * (q - 2.15) ** 2),
                         0.02 * torch.exp(-1.8 * (q - 2.15) ** 2))

        f6 = -0.017 * torch.exp(-(q - 3.0) ** 2)

        mid = (q > 0.7) & (q <= 1.95)
        hi = q > 1.95
        f7 = torch.where(mid, (q - 1.95) / 1.25 + 1.0, 0.0)
        f7 = torch.where(
            hi, torch.exp(-2.0 * (torch.clamp(q, min=1.95) - 1.95)), f7)
        return f1, f2, f3, f4, f5, f6, f7

    def apply(self, params, box_vecs, den):
        alpha, beta = params["alpha"], params["beta"]
        vW = Weizsaecker(box_vecs, den)
        TF = ThomasFermi(box_vecs, den)

        vol = volume(box_vecs)
        n0 = _mean_density(box_vecs, den)
        k_F = (3.0 * np.pi**2 * n0) ** (1.0 / 3.0)

        eta, G_inv = G_inv_lindhard(box_vecs, den)
        q = 2.0 * eta

        kernel = (TF_COEFF * 5.0
                  / (9.0 * alpha**2 * n0 ** (2.0 * alpha - 5.0 / 3.0))
                  * (1.0 / G_inv - 3.0 * eta * eta - 1.0))
        conv = irfftn(kernel * rfftn(den ** alpha - n0**alpha), den.shape)
        NL1 = qmean((den ** alpha - n0**alpha) * conv) * vol

        K_delta = (alpha**2 * n0 ** (2.0 * alpha - 1.0) / 18.0 * k_F**2
                   * (6.0 * alpha - 5.0) * kernel)

        f1, f2, f3, f4, f5, f6, f7 = self._piecewise_fits(q)

        delta_nb_ft = rfftn(den ** beta - n0**beta)
        shape = den.shape

        def iconv(kern):
            return irfftn(delta_nb_ft * kern, shape)

        F1 = iconv(f1)
        F2 = iconv(f1 * q**4)
        nz = q != 0.0
        f1_over_q2 = torch.where(nz, f1 / torch.where(nz, q, 1.0) ** 2, 0.4)
        F3 = iconv(f1_over_q2)
        F4 = iconv(f1 * q**2)
        F5 = iconv(f2 * f3)
        F6 = iconv(f2)
        F7 = iconv(f5)
        F8 = iconv(f4)
        F9 = iconv(f6)
        F10 = iconv(f7)
        F11 = iconv(K_delta)

        delta_nb = den ** beta - n0**beta
        aux = (-13.0 / 540.0 * F1**3 - F2 * F3**2 / 40.0 + F4 * F3 * F1 / 20.0
               + 3.0 * F5 * F6**2 + 3.0 * F7 * F8**2 + 3.0 * F9 * F10**2
               + 3.0 * F11 * delta_nb**2)
        NL2 = (-k_F**2 / beta**3 / n0 ** (3.0 * beta - 1.0)
               * qmean(aux) * vol)
        return vW + TF * self.f((NL1 + NL2) / TF)


# --------------------------------- KGAP ---------------------------------

def G_inv_gap(box_vecs, den, E_gap):
    """Linear response of a gapped jellium (E_gap in eV): (eta, G^-1)."""
    _, _, _, k2 = wavevecs(box_vecs, den.shape)
    k_F = (3.0 * np.pi**2 * _mean_density(box_vecs, den)) ** (1.0 / 3.0)
    eta = safe_sqrt(k2) / (2.0 * k_F)

    delta = 2.0 * (E_gap / EV_PER_HA) / k_F**2

    nz = eta != 0.0
    e = torch.where(nz, eta, 1.0)
    aux_p = 4.0 * (e + e * e)
    aux_m = 4.0 * (e - e * e)
    val = (0.5 - delta * (torch.atan(aux_p / delta)
                          + torch.atan(aux_m / delta))
           / (8.0 * e)
           + (delta * delta / (128.0 * e**3) + 1.0 / (8.0 * e) - e / 8.0)
           * torch.log((delta * delta + aux_p**2)
                       / (delta * delta + aux_m**2)))
    origin = torch.where(delta != 0.0, 0.0, 1.0).to(val.dtype)
    val = torch.where(nz, val, origin)
    if eta.dtype == torch.float32:
        # the gapped closed form cancels catastrophically at large eta,
        # where the gap correction is O(delta^2/eta^2) relative: the f32
        # tier takes the cancellation-safe Lindhard series there
        val = torch.where(eta > 10.0, G_inv_lind(eta), val)
    return eta, val


def _kgap_exponents(E_gap):
    """KGAP's (alpha, beta), interpolated by the gap between SM's (1/2,
    1/2) at E_gap = 0 and WGC98's at large gaps."""
    fraction = E_gap * E_gap / (5.0 + E_gap * E_gap)
    return (0.5 + (WGC98_ALPHA - 0.5) * fraction,
            0.5 + (WGC98_BETA - 0.5) * fraction)


def KGAP(box_vecs, den, E_gap, f=lambda x: 1.0 + x):
    """KGAP: WT-style functional with the gapped-jellium linear response
    (E_gap in eV; ``f`` a torch stabilizer with f(0) = 1)."""
    fprime0 = _stabilizer_fprime0(f, "KGAP")
    alpha, beta = _kgap_exponents(E_gap)

    vol = volume(box_vecs)
    n0 = _mean_density(box_vecs, den)

    eta, G_inv = G_inv_gap(box_vecs, den, E_gap)
    g_tilde = rfftn(den ** beta)

    nz = eta != 0.0
    G_safe = torch.where(nz, G_inv, 1.0)
    kern = torch.where(nz, 1.0 / G_safe - 3.0 * eta * eta - 1.0, 0.0)
    conv = (5.0 / (9.0 * alpha * beta * n0 ** (alpha + beta - 5.0 / 3.0))
            * irfftn(kern * g_tilde, den.shape))
    T_NL = TF_COEFF * qmean(den ** alpha * conv) * vol
    vW, TF = Weizsaecker(box_vecs, den), ThomasFermi(box_vecs, den)
    return vW + TF * f(T_NL / fprime0 / TF)


# ------------------------------ Huang-Carter ------------------------------

@functools.lru_cache(maxsize=16)
def _hc_kernel_table(beta, eta_max=50.0, N_eta=10000, substeps=4):
    """Solve the Huang-Carter kernel ODE w'(eta) backwards from eta_max
    with fixed-step RK4 (host, float64): a Python loop of 160k derivative
    calls, so each table is solved once per process and shared by the
    instances with the same beta (callers copy it)."""
    beta = float(beta)

    def lindhard(eta):
        if eta == 0.0:
            return 1.0
        if eta == 1.0:
            return 2.0
        return 1.0 / (0.5 + (1.0 - eta * eta) / (4.0 * eta)
                      * np.log(abs((1.0 + eta) / (1.0 - eta))))

    def w_prime(eta, w):
        aux = ((5.0 / 3.0) * (lindhard(eta) - 3.0 * eta * eta - 1.0)
               - (5.0 - 3.0 * beta) * beta * w)
        return -aux / beta / eta

    etas = np.linspace(0.0, eta_max, N_eta)
    w = np.empty(N_eta)
    w[-1] = -(8.0 / 3.0) / ((5.0 - 3.0 * beta) * beta)
    for i in range(N_eta - 1, 0, -1):
        h = (etas[i - 1] - etas[i]) / substeps  # negative step
        y = w[i]
        x = etas[i]
        for _ in range(substeps):
            if x + h <= 0.0:
                break
            k1 = w_prime(x, y)
            k2 = w_prime(x + 0.5 * h, y + 0.5 * h * k1)
            k3 = w_prime(x + 0.5 * h, y + 0.5 * h * k2)
            k4 = w_prime(x + h, y + h * k3)
            y = y + h / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
            x = x + h
        w[i - 1] = y
    w[0] = 0.0
    return etas, w


class _HuangCarterBase(KineticFunctional):
    """Shared machinery of HC / revHC: the ODE kernel table, the ladder
    and slab cache, the field-dependent convolution energy."""

    def _setup_ladder(self, kappa):
        self.kappa = kappa
        self.mode = "geometric"
        self.xi_sparse = None
        self.ladder_margin = 1.0
        self._aux = None
        self.generate_kernel()

    def generate_kernel(self, eta_max=50.0, N_eta=10000):
        etas, w = _hc_kernel_table(float(self.params["beta"].detach()),
                                   float(eta_max), int(N_eta))
        self.kernel = (torch.tensor(etas), torch.tensor(w))

    def _xis(self, params, box_vecs, den):
        raise NotImplementedError

    def _table(self, like):
        return tuple(t.to(dtype=like.dtype, device=like.device)
                     for t in self.kernel)

    @torch.no_grad()
    def prepare(self, box_vecs, den):
        """Cache the static xi ladder of this density and the kernel slabs
        W(|k| / xi_i) on the half-spectrum grid of this cell (the slabs
        depend only on the cell, the ladder and beta)."""
        xis = self._xis(self.params, box_vecs, den)
        self.xi_sparse = xi_ladder(float(torch.min(xis)) / self.ladder_margin,
                                   float(torch.max(xis)) * self.ladder_margin,
                                   self.kappa, self.mode)
        lad = torch.tensor(self.xi_sparse, dtype=den.dtype, device=den.device)
        _, _, _, k2 = wavevecs(box_vecs, den.shape)
        q = safe_sqrt(k2)
        eta_1D, w_1D = self._table(den)
        eta = q[..., None] / lad
        slabs = interpolate(eta_1D, w_1D, torch.clamp(eta, max=eta_1D[-1]))
        self._aux = {"ladder": lad, "slabs": slabs}
        return self.xi_sparse

    def aux_arrays(self):
        """The per-cell arrays ``prepare`` hoisted: ladder and slabs."""
        return self._aux

    def apply_aux(self, aux, box_vecs, den):
        return self.apply(self.params, box_vecs, den, aux=aux)

    def forward_static(self, box_vecs, den):
        return self.apply(self.params, box_vecs, den,
                          ladder=_static_ladder(self))

    def apply(self, params, box_vecs, den, aux=None, ladder=None):
        """The energy; ``aux`` (ladder and slabs from ``prepare``) or a
        fixed ``ladder``, else the ladder of this density."""
        _, _, _, k2 = wavevecs(box_vecs, den.shape)
        xis = self._xis(params, box_vecs, den)
        g = den ** params["beta"]

        if aux is not None:
            lad = aux["ladder"].to(den.dtype)
            conv = ladder_convolution(aux["slabs"].to(den.dtype), g,
                                      den.shape)
            K = interpolate_kernel(lad, conv, xis)
        else:
            # tables are built in f64; the working dtype keeps the f32
            # path in f32 / c64
            eta_1D, w_1D = self._table(den)

            def w_tilde(q_, xi_sparse):
                eta = q_[..., None] / xi_sparse
                return interpolate(eta_1D, w_1D,
                                   torch.clamp(eta, max=eta_1D[-1]))

            K = field_dependent_convolution(safe_sqrt(k2), w_tilde, g, xis,
                                            kappa=self.kappa, mode=self.mode,
                                            xi_sparse=ladder)

        C_HC = TF_COEFF * 8.0 * (3.0 * np.pi**2)
        T_NL = (C_HC * qmean(den ** (8.0 / 3.0 - params["beta"]) * K
                             / xis**3)
                * volume(box_vecs))
        return Weizsaecker(box_vecs, den) + ThomasFermi(box_vecs, den) + T_NL


class HuangCarter(_HuangCarterBase):
    """Huang-Carter: single-point density-dependent kernel,
    xi = 2 k_F (1 + lambda |grad n|^2 / n^{8/3}); ``init_args = (lambda,
    beta, kappa)`` with kappa the geometric ladder ratio."""

    def __init__(self, init_args):
        super().__init__(init_args)
        lamb, beta, kappa = init_args
        self._init_params(dict(lamb=lamb, beta=beta))
        self._setup_ladder(kappa)

    def _xis(self, params, box_vecs, den):
        kx, ky, kz, _ = wavevecs(box_vecs, den.shape)
        s2 = grad_dot_grad(kx, ky, kz, den) / (den ** (8.0 / 3.0) + 1e-30)
        k_F = (3.0 * np.pi**2 * den) ** (1.0 / 3.0)
        return 2.0 * k_F * (1.0 + params["lamb"] * s2)


class RevisedHuangCarter(_HuangCarterBase):
    """revHC: xi = 2 k_F (1 + a s^2 / (1 + b s^2)) with the reduced
    gradient s; ``init_args = (a, b, beta, kappa)``."""

    def __init__(self, init_args):
        super().__init__(init_args)
        a, b, beta, kappa = init_args
        self._init_params(dict(a=a, b=b, beta=beta))
        self._setup_ladder(kappa)

    def _xis(self, params, box_vecs, den):
        kx, ky, kz, _ = wavevecs(box_vecs, den.shape)
        s2 = reduced_gradient_squared(kx, ky, kz, den)
        F = 1.0 + params["a"] * s2 / (1.0 + params["b"] * s2)
        k_F = (3.0 * np.pi**2 * den) ** (1.0 / 3.0)
        return 2.0 * k_F * F


# --------------------------- Mi-Genova-Pavanello ---------------------------

class MiGenovaPavanello(KineticFunctional):
    """MGP: line-integral kernel, tabulated numerically, plus an erf^2
    correction; ``init_args = (a, b)``.  The table is built on the first
    ``prepare`` (or call) to cover the grid's largest |k|."""

    def __init__(self, init_args):
        super().__init__(init_args)
        a, b = init_args
        self._init_params(dict(a=a, b=b))
        self.kernel = None
        self._aux = None

    def generate_kernel(self, eta_max=60.0, N_eta=2000, N_int=10000,
                        rows=100):
        """Integrate the 1-D MGP kernel table numerically (host, float64),
        ``rows`` etas at a time to bound the host memory."""
        ts = np.linspace(1e-4, 1.0, N_int)
        dt = ts[1] - ts[0]
        etas = np.linspace(0.0, eta_max, N_eta)
        w = np.empty(N_eta)
        last = np.empty(N_eta)
        for r in range(0, N_eta, rows):
            scaled = etas[r:r + rows, None] / ts[None, :] ** (1.0 / 3.0)
            with np.errstate(divide="ignore", invalid="ignore"):
                lind = 0.5 + (1.0 - scaled**2) / (4.0 * scaled) * np.log(
                    np.abs((1.0 + scaled) / (1.0 - scaled)))
            lind[scaled == 0.0] = 1.0
            lind[scaled == 1.0] = 0.5
            G_NL = 1.0 / lind - 3.0 * scaled**2 - 1.0
            w[r:r + rows] = 0.2 * (3.0 * np.pi**2) ** (2.0 / 3.0) * np.sum(
                G_NL / ts ** (1.0 / 6.0), axis=1) * dt
            last[r:r + rows] = scaled[:, -1]
        self.kernel = (torch.tensor(last), torch.tensor(w))

    @torch.no_grad()
    def prepare(self, box_vecs, den):
        """Make the table cover this grid's eta range, and hoist the full
        k-space kernel of this cell (density-independent given n0)."""
        _, _, _, k2 = wavevecs(box_vecs, den.shape)
        vol = volume(box_vecs)
        N_elec = round(float(torch.mean(den) * vol))
        n0 = N_elec / float(vol)
        k_F = (3.0 * np.pi**2 * n0) ** (1.0 / 3.0)
        eta_max = float(torch.max(safe_sqrt(k2))) / (2.0 * k_F)
        if self.kernel is None or float(self.kernel[0][-1]) < eta_max:
            self.generate_kernel(1.2 * eta_max)
        self._aux = {"kernel": self._kernel_ft(self.params, den.dtype, k2,
                                               k_F)}

    def aux_arrays(self):
        return self._aux

    def apply_aux(self, aux, box_vecs, den):
        return self.apply(self.params, box_vecs, den, aux=aux)

    def _kernel_ft(self, params, dtype, k2, k_F):
        eta = safe_sqrt(k2) / (2.0 * k_F)
        eta_1D, w_1D = (t.to(dtype=dtype, device=k2.device)
                        for t in self.kernel)
        nz = k2 != 0.0
        k2s = torch.where(nz, k2, 1.0)
        w_corr = (torch.special.erf(eta * 2.0 * k_F) ** 2
                  * (4.0 * np.pi * params["a"] / k2s)
                  * torch.exp(-params["b"] * k2s))
        interp_w = interpolate(eta_1D, w_1D, torch.clamp(eta, max=eta_1D[-1]))
        return torch.where(nz, interp_w + 0.6 * w_corr, 0.0).to(dtype)

    def apply(self, params, box_vecs, den, aux=None):
        vol = volume(box_vecs)
        _, _, _, k2 = wavevecs(box_vecs, den.shape)
        k_F = (3.0 * np.pi**2 * _mean_density(box_vecs, den)) ** (1.0 / 3.0)

        if aux is not None:
            MGP_kernel = aux["kernel"].to(den.dtype)
        else:
            if self.kernel is None:
                self.prepare(box_vecs, den)
            MGP_kernel = self._kernel_ft(params, den.dtype, k2, k_F)

        conv = irfftn(MGP_kernel * rfftn(den ** (5.0 / 6.0)), den.shape)
        T_NL = qmean(den ** (5.0 / 6.0) * conv) * vol
        return Weizsaecker(box_vecs, den) + ThomasFermi(box_vecs, den) + T_NL


# -------------------------------- Xu-Wang-Ma --------------------------------

def _xwm_kernels(eta, G_inv, n0, kappa):
    """The three XWM k-space kernels (density-independent given n0),
    shared by the energy and the fused potential."""
    kernel0 = (18.0 / (6.0 * kappa + 5.0) ** 2 * np.pi**2
               / (3.0 * np.pi**2) ** (1.0 / 3.0)
               * (1.0 / G_inv - 3.0 * eta * eta - 1.0) / n0 ** (2.0 * kappa))

    nz = eta != 0.0
    e = torch.where(nz, eta, 1.0)
    sing = torch.abs(e - 1.0) < 1e-30
    e_safe = torch.where(sing, 2.0, e)
    G_der = 0.5 - 0.25 * (e_safe + 1.0 / e_safe) * torch.log(
        torch.abs((1.0 + e_safe) / (1.0 - e_safe)))
    # large-eta series (the log form cancels catastrophically, cf.
    # G_inv_lind): G_der = -sum_k 2k/((2k-1)(2k+1)) eta^-2k, k = 1..7;
    # truncation ~1e-15 at the eta = 10 switch point
    u = 1.0 / torch.where(e_safe > 10.0, e_safe, 10.0) ** 2
    ks = [2.0 * k / ((2.0 * k - 1.0) * (2.0 * k + 1.0)) for k in range(1, 8)]
    series = -u * (ks[0] + u * (ks[1] + u * (ks[2] + u * (ks[3] + u * (
        ks[4] + u * (ks[5] + u * ks[6]))))))
    G_der = torch.where(e_safe > 10.0, series, G_der)
    G_inv_der = torch.where(nz & ~sing, G_der, 0.0)

    kernel1 = (np.pi**2 / (3.0 * np.pi**2) ** (1.0 / 3.0) / (6.0 * n0)
               * (G_inv_der / G_inv**2 + 6.0 * eta * eta)
               / n0 ** (2.0 * kappa))
    kernel1a = kernel1 / ((kappa + 5.0 / 6.0) * (kappa + 11.0 / 6.0))
    kernel1b = n0 / (kappa + 5.0 / 6.0) ** 2 * kernel1
    return kernel0, kernel1a, kernel1b


def XuWangMa(box_vecs, den, kappa=0.0):
    """XWM: line-integral kernel with a first-order Taylor expansion of
    its density dependence."""
    vol = volume(box_vecs)
    n0 = _mean_density(box_vecs, den)

    eta, G_inv = G_inv_lindhard(box_vecs, den)
    shape = den.shape
    kernel0, kernel1a, kernel1b = _xwm_kernels(eta, G_inv, n0, kappa)

    conv = irfftn(kernel0 * rfftn(den ** (kappa + 5.0 / 6.0)), shape)
    T_NL0 = qmean(den ** (kappa + 5.0 / 6.0) * conv) * vol

    conva = irfftn(kernel1a * rfftn(den ** (kappa + 11.0 / 6.0)), shape)
    T_NL1a = qmean(den ** (kappa + 5.0 / 6.0) * conva) * vol

    convb = irfftn(kernel1b * rfftn(den ** (kappa + 5.0 / 6.0)), shape)
    T_NL1b = qmean(den ** (kappa + 5.0 / 6.0) * convb) * vol

    return (Weizsaecker(box_vecs, den) + ThomasFermi(box_vecs, den)
            + T_NL0 + T_NL1a - T_NL1b)
