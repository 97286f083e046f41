"""Local and semi-local kinetic energy functionals: Thomas-Fermi, von
Weizsaecker, vWGTF1/2, Luo-Karasiev-Trickey, the trainable
Pauli-Gaussian family and Yukawa-GGA (its descriptor a field-dependent
convolution on the xi ladder).

PyTorch port of ``professad_tpu/models/kinetic_local.py``.  Powers are
``torch.pow``: the JAX package's
``powr`` exists for the TPU's approximate pow and has no counterpart here.
Every energy body goes through ``torch.fft`` (never the spectral-convolution
kernel), so it is differentiable with respect to the cell.
"""

import numpy as np
import torch

from ..ops.grid import (wavevecs, volume, laplacian, safe_sqrt, qmean, wmean,
                        reduced_gradient, reduced_gradient_squared,
                        reduced_laplacian)
from ..ops.fieldconv import (field_dependent_convolution,
                             field_dependent_convolution_naive, xi_ladder)
from .base import KineticFunctional

__all__ = ["ThomasFermi", "Weizsaecker", "vWGTF1", "vWGTF2",
           "LuoKarasievTrickey", "PauliGaussian", "YukawaGGA", "TF_COEFF"]

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


def _abs(x):
    """|x| whose derivative at 0 is +1, as ``jnp.abs``'s is (``torch.abs``
    has 0 there, which would hold a parameter that starts at 0 fixed in
    training)."""
    return torch.where(x < 0, -x, x)


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
        F_enh = (torch.exp(-_abs(params["mu"]) * s2)
                 + _abs(params["beta"]) * q * q
                 - _abs(params["lamb"]) * q * s2
                 + _abs(params["sigma"]) * s2 * s2)
        pauli_T = qmean(TF_ked * F_enh) * volume(box_vecs)
        return Weizsaecker(box_vecs, den) + pauli_T


def _T_a(a, x):
    """T_a(x) = 1 + (2/a) tanh(a x / 2)."""
    return 1.0 + (2.0 / a) * torch.tanh((a / 2.0) * x)


def _static_ladder(term):
    """The ladder ``prepare`` cached: the one the optimizer paths, the
    stress and the functional derivatives use (the JAX package's traced
    calls)."""
    if term.xi_sparse is None:
        raise RuntimeError(
            f"{type(term).__name__}: call prepare(box_vecs, den) with the "
            "system's density before its optimizer or derivative paths.")
    return term.xi_sparse


class YukawaGGA(KineticFunctional):
    """Yukawa-GGA family: Pauli factor F(y, s^2, q) on the Thomas-Fermi
    energy density, plus vW, where y is the Yukawa descriptor, a
    field-dependent convolution by the spline method.

    ``init_args = (alpha, beta, F_pauli, kappa)``; the default is yuk1
    (F = y, alpha = beta = 1, kappa = 1.2).  The setters ``set_yuk1`` ...
    ``set_yuk3beta`` choose a preset and tag it, so that the fused
    potential can use the preset's closed-form partials; a user callable
    stays autograd-only.

    The ladder: a direct call sizes it from the density it is given;
    ``prepare`` caches one (``xi_sparse``) from the system's density, and
    ``forward_static`` (what ``System`` differentiates) and the fused
    potential use that one."""

    def __init__(self, init_args=None):
        super().__init__(init_args)
        if init_args is None:
            alpha, beta, func, kappa = 1.0, 1.0, (lambda y, s2, q: y), 1.2
            self._preset = ("yuk1",)   # the default F = y is yuk1's form
        else:
            alpha, beta, func, kappa = init_args
            self._preset = None        # user callable: autograd only
        self._init_params(dict(alpha=alpha, beta=beta))
        self.F_pauli = func
        self.kappa = kappa
        self.mode = "geometric"
        self.spline = True
        self.xi_sparse = None
        self.ladder_margin = 1.0

    # -- presets (each setter tags the instance for the fused potential) --
    def _set(self, alpha, beta, func, preset):
        self.load_params(dict(alpha=alpha, beta=beta))
        self.F_pauli = func
        self._preset = preset

    def set_yuk1(self):
        self._set(1.0, 1.0, lambda y, s2, q: y, ("yuk1",))

    def set_yuk2(self):
        self._set(1.3629, 1.0,
                  lambda y, s2, q: y * (1.0 + 40.0 / 27.0 * (q - s2)),
                  ("yuk2",))

    def set_yuk3(self, a=4.0):
        self._set(1.3629, 1.0,
                  lambda y, s2, q: y * _T_a(a, 40.0 / 27.0 * (q - s2)),
                  ("yuk3", a))

    def set_yuk4(self, a=3.3):
        self._set(1.3629, 1.0,
                  lambda y, s2, q: (y * _T_a(a, -40.0 / 27.0 * s2)
                                    * _T_a(2.0, 40.0 / 27.0 * q)),
                  ("yuk4", a))

    def _G0_G(self, s2, q):
        alpha, beta = self.params["alpha"], self.params["beta"]
        G0 = (alpha**2 * (alpha**2 - 60.0)
              / (108.0 * beta * (9.0 * beta - 10.0)))
        G = ((40.0 / 27.0 / beta - 4.0 / alpha**2 * (beta - 1.0) * G0)
             * (q - beta * s2))
        return G0, G

    def set_yuk2beta(self, alpha, beta):
        def func(y, s2, q):
            G0, G = self._G0_G(s2, q)
            return 1.0 - G0 + y * (G0 + G)
        self._set(alpha, beta, func, ("yuk2beta",))

    def set_yuk3beta(self, alpha, beta, a=2.0):
        def func(y, s2, q):
            G0, G = self._G0_G(s2, q)
            return _T_a(a, -G0 + y * (G0 + G))
        self._set(alpha, beta, func, ("yuk3beta", a))

    # -- ladder -----------------------------------------------------------
    @torch.no_grad()
    def prepare(self, box_vecs, den):
        """Cache the xi ladder of this density."""
        k_F = (3.0 * np.pi**2 * den) ** (1.0 / 3.0)
        xis = float(self.params["alpha"].detach()) * k_F
        lo = float(torch.min(xis)) / self.ladder_margin
        hi = float(torch.max(xis)) * self.ladder_margin
        self.xi_sparse = xi_ladder(lo, hi, self.kappa, self.mode)
        return self.xi_sparse

    def yukawa_descriptor(self, params, k2, den, ladder=None):
        """Yukawa descriptor y(r).  ``self.spline = False`` selects the
        exact per-point evaluation, O(N^2): the cross-check oracle of the
        ladder method, for coarse grids."""
        k_F = (3.0 * np.pi**2 * den) ** (1.0 / 3.0)
        xis = params["alpha"] * k_F
        g = den ** params["beta"]

        def K_tilde(k2_, xi_sparse):
            return 4.0 * np.pi / (k2_[..., None] + xi_sparse**2)

        if not self.spline:
            u = field_dependent_convolution_naive(k2, K_tilde, g, xis)
        else:
            u = field_dependent_convolution(k2, K_tilde, g, xis,
                                            kappa=self.kappa, mode=self.mode,
                                            xi_sparse=ladder)
        return (3.0 * np.pi * params["alpha"]**2
                / (4.0 * k_F * den ** (params["beta"] - 1.0)) * u)

    def apply(self, params, box_vecs, den, ladder=None):
        vol = volume(box_vecs)
        kx, ky, kz, k2 = wavevecs(box_vecs, den.shape)
        y = self.yukawa_descriptor(params, k2, den, ladder)
        s2 = reduced_gradient_squared(kx, ky, kz, den)
        q = reduced_laplacian(k2, den)
        F_pauli = self.F_pauli(y, s2, q)
        TF_ked = TF_COEFF * den ** (5.0 / 3.0)
        return Weizsaecker(box_vecs, den) + qmean(TF_ked * F_pauli) * vol

    def forward_static(self, box_vecs, den):
        """The energy on the ladder ``prepare`` cached (when
        ``spline``)."""
        ladder = _static_ladder(self) if self.spline else None
        return self.apply(self.params, box_vecs, den, ladder)
