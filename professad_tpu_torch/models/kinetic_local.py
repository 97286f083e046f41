"""Local and semi-local kinetic energy functionals: Thomas-Fermi and von
Weizsaecker.

PyTorch port of the corresponding part of
``professad_tpu/models/kinetic_local.py``.  Powers are ``torch.pow``: the
JAX package's ``powr`` exists for the TPU's approximate pow and has no
counterpart here.
"""

import numpy as np

from ..ops.grid import wavevecs, volume, laplacian, safe_sqrt, qmean

__all__ = ["ThomasFermi", "Weizsaecker", "TF_COEFF"]

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
