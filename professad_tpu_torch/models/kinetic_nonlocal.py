"""Non-local kinetic energy functionals: the Lindhard response and
Wang-Teter.

PyTorch port of the corresponding part of
``professad_tpu/models/kinetic_nonlocal.py``.  Masked singular expressions
keep the double-``where`` idiom so gradients stay NaN-free.
"""

import numpy as np
import torch

from ..ops.grid import wavevecs, volume, safe_sqrt, qmean, wmean, rfftn, irfftn
from .kinetic_local import ThomasFermi, Weizsaecker, TF_COEFF

__all__ = ["G_inv_lind_analytical", "G_inv_lind", "G_inv_lindhard",
           "non_local_KEF", "WangTeter"]


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
