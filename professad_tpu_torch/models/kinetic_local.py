"""Local and semi-local kinetic energy functionals: Thomas-Fermi, von
Weizsaecker, vWGTF1/2, Luo-Karasiev-Trickey and the trainable
Pauli-Gaussian family.

PyTorch port of ``professad_tpu/models/kinetic_local.py`` (YukawaGGA is not
ported yet: ROADMAP A7).  Powers are ``torch.pow``: the JAX package's
``powr`` exists for the TPU's approximate pow and has no counterpart here.
Every energy body goes through ``torch.fft`` (never the spectral-convolution
kernel), so it is differentiable with respect to the cell.
"""

import numpy as np
import torch

from ..ops.grid import (wavevecs, volume, laplacian, safe_sqrt, qmean, wmean,
                        reduced_gradient, reduced_gradient_squared,
                        reduced_laplacian)
from .base import KineticFunctional

__all__ = ["ThomasFermi", "Weizsaecker", "vWGTF1", "vWGTF2",
           "LuoKarasievTrickey", "PauliGaussian", "TF_COEFF"]

TF_COEFF = 0.3 * (3.0 * np.pi**2) ** (2.0 / 3.0)


def ThomasFermi(box_vecs, den):
    """T_TF = c_TF int n^{5/3}."""
    return TF_COEFF * qmean(den ** (5.0 / 3.0)) * volume(box_vecs)


def Weizsaecker(box_vecs, den):
    """T_vW = 1/8 int |grad n|^2 / n, evaluated in Laplacian form as
    1/4 lap n - 1/2 sqrt(n) lap sqrt(n)."""
    sqrt_den = safe_sqrt(den)
    _, _, _, k2 = wavevecs(box_vecs, den.shape)
    ked = 0.25 * laplacian(k2, den) - 0.5 * sqrt_den * laplacian(k2, sqrt_den)
    return qmean(ked) * volume(box_vecs)


def _mean_density(box_vecs, den):
    """n0 = N_e / vol with N_e rounded and detached."""
    vol = volume(box_vecs)
    return torch.round((wmean(den) * vol).detach()) / vol


def vWGTF1(box_vecs, den):
    """vWGTF1: G(d) = 0.9892 d^{-1.2994}, d = n / n0."""
    d = den / _mean_density(box_vecs, den)
    G = 0.9892 * d ** (-1.2994)
    TF_ked = TF_COEFF * den ** (5.0 / 3.0)
    return Weizsaecker(box_vecs, den) + qmean(G * TF_ked) * volume(box_vecs)


def vWGTF2(box_vecs, den):
    """vWGTF2: the ELF-parameterised enhancement."""
    d = den / _mean_density(box_vecs, den)
    ELF = 0.5 * (1.0 + torch.tanh(5.7001 * d ** 0.2563 - 5.7001))
    G = torch.sqrt(1.0 / ELF - 1.0)
    TF_ked = TF_COEFF * den ** (5.0 / 3.0)
    return Weizsaecker(box_vecs, den) + qmean(G * TF_ked) * volume(box_vecs)


def LuoKarasievTrickey(box_vecs, den):
    """LKT GGA: F = 1/cosh(1.3 s), s clamped at 100 against NaN
    gradients."""
    TF_ked = TF_COEFF * den ** (5.0 / 3.0)
    kx, ky, kz, _ = wavevecs(box_vecs, den.shape)
    s = torch.clamp(reduced_gradient(kx, ky, kz, den), max=100.0)
    F_pauli = 1.0 / torch.cosh(1.3 * s)
    pauli_T = qmean(TF_ked * F_pauli) * volume(box_vecs)
    return Weizsaecker(box_vecs, den) + pauli_T


class PauliGaussian(KineticFunctional):
    """Pauli-Gaussian family: F = e^{-mu s^2} + beta q^2 - lambda q s^2
    + sigma s^4 on the TF energy density, plus vW.  Defaults to
    PGSL0.25."""

    def __init__(self, init_args=None):
        super().__init__(init_args)
        if init_args is None:
            init_args = (40.0 / 27.0, 0.25, 0.0, 0.0)
        mu, beta, lamb, sigma = init_args
        self._init_params(dict(mu=mu, beta=beta, lamb=lamb, sigma=sigma))

    def _set(self, mu, beta, lamb, sigma):
        self.load_params(dict(mu=mu, beta=beta, lamb=lamb, sigma=sigma))

    def set_PG1(self):
        self._set(1.0, 0.0, 0.0, 0.0)

    def set_PGS(self):
        self._set(40.0 / 27.0, 0.0, 0.0, 0.0)

    def set_PGSL025(self):
        self._set(40.0 / 27.0, 0.25, 0.0, 0.0)

    def set_PGSLr(self):
        self._set(40.0 / 27.0, 0.25, 0.4, 0.2)

    def apply(self, params, box_vecs, den):
        TF_ked = TF_COEFF * den ** (5.0 / 3.0)
        kx, ky, kz, k2 = wavevecs(box_vecs, den.shape)
        s2 = reduced_gradient_squared(kx, ky, kz, den)
        q = reduced_laplacian(k2, den)
        F_enh = (torch.exp(-torch.abs(params["mu"]) * s2)
                 + torch.abs(params["beta"]) * q * q
                 - torch.abs(params["lamb"]) * q * s2
                 + torch.abs(params["sigma"]) * s2 * s2)
        pauli_T = qmean(TF_ked * F_enh) * volume(box_vecs)
        return Weizsaecker(box_vecs, den) + pauli_T
