"""Exchange-correlation: the LDA family (Dirac exchange with the PZ81, PW92
or Chachiyo correlation) and PBE.

PyTorch port of ``professad_tpu/models/xc.py``.  Singular denominators
keep the same 1e-30 guards, so results and gradients match the JAX package
to 1e-10; ``log_hp`` / ``powr`` (TPU fixes) are ``torch.log`` /
``torch.pow``.
"""

import numpy as np
import torch

from ..ops.grid import wavevecs, volume, grad_dot_grad, qmean

__all__ = ["lda_exchange", "perdew_zunger_correlation",
           "perdew_wang_correlation", "chachiyo_correlation",
           "PerdewZunger", "PerdewWang", "Chachiyo",
           "pbe_exchange", "pbe_correlation", "PerdewBurkeErnzerhof"]


def _rs(den):
    return (3.0 / (4.0 * np.pi) / den) ** (1.0 / 3.0)


def lda_exchange(box_vecs, den):
    """Dirac LDA exchange."""
    return (-(3.0 / 4.0) * (3.0 / np.pi) ** (1.0 / 3.0)
            * qmean(den ** (4.0 / 3.0)) * volume(box_vecs))


def perdew_zunger_correlation(box_vecs, den):
    """PZ81 correlation."""
    gamma, beta1, beta2 = -0.1423, 1.0529, 0.3334
    A, B, C, D = 0.0311, -0.048, 0.002, -0.0116
    rs = _rs(den)
    log_rs = torch.log(rs)
    eps_hi = A * log_rs + B + C * rs * log_rs + D * rs
    eps_lo = gamma / (1.0 + beta1 * torch.sqrt(rs) + beta2 * rs)
    eps_c = torch.where(rs < 1.0, eps_hi, eps_lo)
    return qmean(eps_c * den) * volume(box_vecs)


def _pw92_eps(rs):
    A, alpha = 0.0310907, 0.2137
    b1, b2, b3, b4 = 7.5957, 3.5876, 1.6382, 0.49294
    srs = torch.sqrt(rs)
    zeta = 2.0 * A * (b1 * srs + b2 * rs + b3 * rs * srs + b4 * rs * rs)
    return -2.0 * A * (1.0 + alpha * rs) * torch.log(1.0 + 1.0 / zeta)


def perdew_wang_correlation(box_vecs, den):
    """PW92 correlation."""
    return qmean(_pw92_eps(_rs(den)) * den) * volume(box_vecs)


def chachiyo_correlation(box_vecs, den):
    """Chachiyo 2016 correlation."""
    a = float(np.log(2.0) - 1.0) / (2.0 * np.pi**2)
    b = 20.4562557
    rs = _rs(den)
    eps_c = a * torch.log(1.0 + b / rs + b / rs**2)
    return qmean(eps_c * den) * volume(box_vecs)


def PerdewZunger(box_vecs, den):
    """LDA XC: Dirac exchange + PZ81 correlation."""
    return lda_exchange(box_vecs, den) + perdew_zunger_correlation(box_vecs,
                                                                   den)


def PerdewWang(box_vecs, den):
    """LDA XC: Dirac exchange + PW92 correlation."""
    return lda_exchange(box_vecs, den) + perdew_wang_correlation(box_vecs,
                                                                 den)


def Chachiyo(box_vecs, den):
    """LDA XC: Dirac exchange + Chachiyo correlation."""
    return lda_exchange(box_vecs, den) + chachiyo_correlation(box_vecs, den)


def _pbe_exchange_density(den, gdg):
    """PBE exchange energy density from den and |grad n|^2."""
    eps_x = -(3.0 / 4.0) * (3.0 / np.pi) ** (1.0 / 3.0) * den ** (4.0 / 3.0)
    s2 = (0.25 * (3.0 * np.pi**2) ** (-2.0 / 3.0)
          * gdg * den ** (-8.0 / 3.0))
    kappa = 0.804
    mu = 0.066725 * np.pi**2 / 3.0
    Fx = 1.0 + kappa - kappa / (1.0 + mu / kappa * s2)
    return Fx * eps_x


def _pbe_correlation_density(den, gdg):
    """PBE correlation energy density from den and |grad n|^2."""
    eps_c = _pw92_eps(_rs(den))
    beta = 0.066725
    gamma = float(1.0 - np.log(2.0)) / np.pi**2
    A = beta / gamma / (torch.exp(-eps_c / gamma) - 1.0 + 1e-30)
    t2 = ((1.0 / 16.0) * (np.pi / 3.0) ** (1.0 / 3.0)
          * gdg / (den ** (7.0 / 3.0) + 1e-30))
    At2 = A * t2
    H = gamma * torch.log(1.0 + beta / gamma * t2 * (1.0 + At2)
                          / (1.0 + At2 + At2 * At2))
    return (eps_c + H) * den


def pbe_exchange(box_vecs, den):
    """PBE exchange."""
    kx, ky, kz, _ = wavevecs(box_vecs, den.shape)
    gdg = grad_dot_grad(kx, ky, kz, den)
    return qmean(_pbe_exchange_density(den, gdg)) * volume(box_vecs)


def pbe_correlation(box_vecs, den):
    """PBE correlation."""
    kx, ky, kz, _ = wavevecs(box_vecs, den.shape)
    gdg = grad_dot_grad(kx, ky, kz, den)
    return qmean(_pbe_correlation_density(den, gdg)) * volume(box_vecs)


def PerdewBurkeErnzerhof(box_vecs, den):
    """PBE XC: exchange + correlation."""
    return pbe_exchange(box_vecs, den) + pbe_correlation(box_vecs, den)
