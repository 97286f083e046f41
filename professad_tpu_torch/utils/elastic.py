"""Equation-of-state fitting and elastic-moduli post-processing.

PyTorch port of ``professad_tpu/utils/elastic.py``.  The fit runs on the
host with scipy, as in the JAX package; the moduli helpers accept tensors
or numpy arrays (``reuss_moduli`` inverts on the host in numpy).
"""

import numpy as np
import torch

__all__ = ["fit_eos", "voigt_moduli", "reuss_moduli", "shear_average",
           "poissons_ratio", "youngs_modulus"]


def _host(a):
    """float64 numpy view of a tensor, array or list."""
    if torch.is_tensor(a):
        a = a.detach().cpu()
    return np.asarray(a, dtype=np.float64)


def fit_eos(vol, ene, eos="bm", plot=False):
    """Fit (V, E) data to the Murnaghan ('m') or Birch-Murnaghan ('bm')
    equation of state.  Returns (params, errors), params ordered
    (K0, K0', E0, V0) in the units of the data."""
    from scipy.optimize import curve_fit
    vol, ene = _host(vol), _host(ene)
    # harmonic-solid initial guess: E = E0 + 0.5 K0 (V - V0)^2 / V0
    apar, bpar, cpar = np.polyfit(vol, ene, 2)
    K0_g = -bpar
    V0_g = K0_g / (2 * apar)
    E0_g = cpar - 0.5 * K0_g * V0_g
    K0prime_g = 3.5

    def murn(v, K0, K0prime, E0, V0):
        if eos == "m":
            return (E0 + (K0 * v / K0prime) * ((((V0 / v) ** K0prime)
                    / (K0prime - 1)) + 1) - K0 * V0 / (K0prime - 1))
        if eos == "bm":
            x = (V0 / v) ** (2.0 / 3.0) - 1.0
            return E0 + 9 * V0 * K0 / 16 * (
                K0prime * x**3 + x**2 * (6 - 4 * ((V0 / v) ** (2.0 / 3.0))))
        raise ValueError("Only 'm' or 'bm' recognized for 'eos'")

    params, pcov = curve_fit(murn, vol, ene,
                             p0=(K0_g, K0prime_g, E0_g, V0_g), maxfev=1000)
    err = np.sqrt(np.diag(pcov))
    if plot:  # pragma: no cover - interactive convenience
        import matplotlib.pyplot as plt
        plt.plot(vol, ene, "rx")
        vfit = np.linspace(0.99 * vol[0], 1.01 * vol[-1])
        plt.plot(vfit, murn(vfit, *params), "b-")
        plt.xlabel("Volume/A^3")
        plt.ylabel("Energy/eV")
        plt.legend(["data", "fit"], loc="best")
        plt.show()
    return params, err


def voigt_moduli(C):
    """Voigt bulk and shear moduli of a 6x6 elastic-constant matrix (a
    tensor gives tensors, anything else numpy)."""
    C = C if torch.is_tensor(C) else _host(C)
    K = (1.0 / 9.0) * ((C[0, 0] + C[1, 1] + C[2, 2])
                       + 2 * (C[0, 1] + C[1, 2] + C[0, 2]))
    G = (1.0 / 15.0) * ((C[0, 0] + C[1, 1] + C[2, 2])
                        - (C[0, 1] + C[1, 2] + C[0, 2])
                        + 3 * (C[3, 3] + C[4, 4] + C[5, 5]))
    return K, G


def reuss_moduli(C):
    """Reuss bulk and shear moduli from the compliance S = C^-1 (host
    numpy)."""
    S = np.linalg.inv(_host(C))
    K = 1.0 / ((S[0, 0] + S[1, 1] + S[2, 2])
               + 2 * (S[0, 1] + S[1, 2] + S[0, 2]))
    G = 15.0 / (4 * (S[0, 0] + S[1, 1] + S[2, 2])
                - 4 * (S[0, 1] + S[1, 2] + S[0, 2])
                + 3 * (S[3, 3] + S[4, 4] + S[5, 5]))
    return K, G


def shear_average(C, mean_type="arithmetic"):
    """Voigt-Reuss average shear modulus."""
    _, Gv = voigt_moduli(_host(C))
    _, Gr = reuss_moduli(C)
    if mean_type == "arithmetic":
        return 0.5 * (Gv + Gr)
    if mean_type == "geometric":
        return (Gv * Gr) ** 0.5
    raise ValueError("mean_type must be 'arithmetic' or 'geometric'")


def poissons_ratio(K, G):
    """nu = (1 - 3G / (3K + G)) / 2."""
    return 0.5 * (1.0 - 3.0 * G / (3.0 * K + G))


def youngs_modulus(K, G):
    """E = 1 / (1/(3G) + 1/(9K))."""
    return 1.0 / (1.0 / (3.0 * G) + 1.0 / (9.0 * K))
