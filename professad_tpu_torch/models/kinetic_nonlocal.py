"""Non-local kinetic energy functionals: the Lindhard response and the
Wang-Teter family (WT, Perrot, SM, WGC98 and the trainable WT-style
template).

PyTorch port of the corresponding part of
``professad_tpu/models/kinetic_nonlocal.py`` (WGC99, Foley-Madden, KGAP,
Huang-Carter, revHC, MGP and XWM are not ported yet: ROADMAP A7).  Masked
singular expressions keep the double-``where`` idiom so gradients stay
NaN-free.  The energy bodies convolve through ``torch.fft``, never the
spectral-convolution kernel, so they are differentiable with respect to
the cell.
"""

import numpy as np
import torch

from ..ops.grid import wavevecs, volume, safe_sqrt, qmean, wmean, rfftn, irfftn
from .base import KineticFunctional
from .kinetic_local import ThomasFermi, Weizsaecker, TF_COEFF

__all__ = ["G_inv_lind_analytical", "G_inv_lind", "G_inv_lindhard",
           "non_local_KEF", "WangTeter", "Perrot", "SmargiassiMadden",
           "WangGovindCarter98", "WangTeterStyleFunctional"]


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
        zero = torch.zeros((), dtype=torch.float64)
        if float(f(zero)) != 1.0:
            raise ValueError("WangTeterStyleFunctional requires f(0) = 1")
        self.fprime0 = float(torch.func.grad(f)(zero))

    def apply(self, params, box_vecs, den):
        vW = Weizsaecker(box_vecs, den)
        TF = ThomasFermi(box_vecs, den)
        T_NL = non_local_KEF(box_vecs, den, params["alpha"],
                             params["beta"]) / self.fprime0
        return vW + TF * self.f(T_NL / TF)
