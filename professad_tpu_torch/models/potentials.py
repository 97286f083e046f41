"""Fused analytic energy + functional-derivative (potential) evaluation.

PyTorch port of ``professad_tpu/models/potentials.py`` for the term set of
the density-optimization path: IonElectron, Hartree, ThomasFermi,
Weizsaecker, WangTeter and PBE.  Each term contributes (E, dE/dn) through a
shared ``SpectralCtx``, so the density spectrum, the gradient fields and the
wavevectors are computed once per evaluation: one forward sweep, no
autograd graph, 13 3-D transforms for WT+PBE.  The dedicated convolutions
(the vW Laplacian and the WT kernel) go through
``grid.spectral_convolution``, i.e. the CUDA spectral-convolution kernel on
the card.

E is accumulated in f64 (``qmean`` returns f64 for f32 fields); dE/dn is in
the working dtype, per grid point, NOT scaled by the quadrature weight.
Other terms raise ``KeyError`` (``supported_terms`` returns False).
"""

import numpy as np
import torch

from ..ops.grid import (wavevecs, volume, qmean, wmean, safe_sqrt, rfftn,
                        irfftn, imul, spectral_convolution)
from ..utils.naming import term_name
from .kinetic_local import TF_COEFF
from .kinetic_nonlocal import G_inv_lind

__all__ = ["value_and_potential", "supported_terms", "SpectralCtx"]


class SpectralCtx:
    """Lazily cached shared fields for one (box_vecs, den) evaluation."""

    def __init__(self, box_vecs, den, v_ext=None, N_elec=None):
        self.box_vecs = box_vecs
        self.den = den
        self.v_ext = v_ext
        self.shape = tuple(den.shape)
        self.vol = volume(box_vecs)
        if N_elec is None:
            N_elec = wmean(den).detach() * self.vol
        self.n0 = N_elec / self.vol  # differentiable through vol
        self._c = {}

    def _get(self, key, fn):
        if key not in self._c:
            self._c[key] = fn()
        return self._c[key]

    @property
    def kvecs(self):
        return self._get("kvecs",
                         lambda: wavevecs(self.box_vecs, self.shape))

    @property
    def den_ft(self):
        return self._get("den_ft", lambda: rfftn(self.den))

    @property
    def grads(self):
        """(dn/dx, dn/dy, dn/dz) from the shared den_ft."""
        def mk():
            kx, ky, kz, _ = self.kvecs
            return tuple(irfftn(imul(k, self.den_ft), self.shape)
                         for k in (kx, ky, kz))
        return self._get("grads", mk)

    @property
    def gdg(self):
        """|grad n|^2 from the shared gradient fields."""
        def mk():
            gx, gy, gz = self.grads
            return gx * gx + gy * gy + gz * gz
        return self._get("gdg", mk)

    @property
    def sqrt_den(self):
        return self._get("sqrt_den", lambda: safe_sqrt(self.den))

    @property
    def lap_sqrt_den(self):
        def mk():
            _, _, _, k2 = self.kvecs
            return spectral_convolution(-k2, self.sqrt_den, self.shape)
        return self._get("lap_sqrt_den", mk)

    def divergence(self, fx, fy, fz):
        """div F as one inverse transform (3 forward + 1 inverse)."""
        kx, ky, kz, _ = self.kvecs
        F = imul(kx, rfftn(fx)) + imul(ky, rfftn(fy)) + imul(kz, rfftn(fz))
        return irfftn(F, self.shape)


# --------------------------- per-term (E, dE/dn) ---------------------------

def _vp_ion_electron(ctx):
    E = qmean(ctx.den * ctx.v_ext) * ctx.vol
    return E, ctx.v_ext


def _vp_hartree(ctx):
    _, _, _, k2 = ctx.kvecs
    nz = k2 != 0
    coul = torch.where(nz, 4.0 * np.pi / torch.where(nz, k2, 1.0), 0.0)
    v_h = irfftn(coul * ctx.den_ft, ctx.shape)
    E = 0.5 * qmean(ctx.den * v_h) * ctx.vol
    return E, v_h


def _vp_thomas_fermi(ctx):
    E = TF_COEFF * qmean(ctx.den ** (5.0 / 3.0)) * ctx.vol
    pot = (5.0 / 3.0) * TF_COEFF * ctx.den ** (2.0 / 3.0)
    return E, pot


def _vp_weizsaecker(ctx):
    """Laplacian form: the 1/4 lap(n) piece integrates to zero on the
    periodic grid, so E = -1/2 qmean(sqrt(n) lap sqrt(n)) vol shares the one
    convolution with the potential -1/2 lap(sqrt n)/sqrt n."""
    lap_s = ctx.lap_sqrt_den
    E = -0.5 * qmean(ctx.sqrt_den * lap_s) * ctx.vol
    pos = ctx.den > 0
    pot = torch.where(pos, -0.5 * lap_s / torch.where(pos, ctx.sqrt_den, 1.0),
                      0.0)
    return E, pot


def _vp_nlkef(ctx, alpha, beta):
    """Wang-Teter-style nonlocal term, fused E + potential."""
    _, _, _, k2 = ctx.kvecs
    n0 = ctx.n0
    k_F = (3.0 * np.pi**2 * n0) ** (1.0 / 3.0)
    eta = safe_sqrt(k2) / (2.0 * k_F)
    G_inv = G_inv_lind(eta)
    kern = (5.0 / (9.0 * alpha * beta * n0 ** (alpha + beta - 5.0 / 3.0))
            * (1.0 / G_inv - 3.0 * eta * eta - 1.0))
    d_a = ctx.den ** alpha - n0 ** alpha
    if alpha == beta:
        conv_b = spectral_convolution(kern, d_a, ctx.shape)
        conv_a = conv_b
        d_b = d_a
    else:
        d_b = ctx.den ** beta - n0 ** beta
        conv_b = irfftn(kern * rfftn(d_b), ctx.shape)
        conv_a = irfftn(kern * rfftn(d_a), ctx.shape)
    E = TF_COEFF * qmean(d_a * conv_b) * ctx.vol
    pot = TF_COEFF * (alpha * ctx.den ** (alpha - 1.0) * conv_b
                      + beta * ctx.den ** (beta - 1.0) * conv_a)
    return E, pot


def _pw92_eps_and_deriv(den):
    """PW92 eps_c and d eps_c/dn."""
    A, alpha = 0.0310907, 0.2137
    b1, b2, b3, b4 = 7.5957, 3.5876, 1.6382, 0.49294
    rs = (3.0 / (4.0 * np.pi) / den) ** (1.0 / 3.0)
    srs = torch.sqrt(rs)
    zeta = 2.0 * A * (b1 * srs + b2 * rs + b3 * rs * srs + b4 * rs * rs)
    lg = torch.log(1.0 + 1.0 / zeta)
    eps = -2.0 * A * (1.0 + alpha * rs) * lg
    deps_dn = (-rs / 3.0 / den
               * (-2.0 * A * alpha * lg
                  + (2.0 * A * A * (1.0 + alpha * rs)
                     * (b1 / srs + 2.0 * b2 + 3.0 * b3 * srs + 4.0 * b4 * rs)
                     / (zeta * (zeta + 1.0)))))
    return eps, deps_dn


def _vp_pbe(ctx):
    """PBE exchange + correlation fused: shared gradient fields, and the
    two divergence terms combined into ONE divergence evaluation."""
    den = ctx.den
    gdg = ctx.gdg

    # exchange
    eps = -(3.0 / 4.0) * (3.0 / np.pi) ** (1.0 / 3.0) * den ** (1.0 / 3.0)
    deps_dn = -(1.0 / 4.0) * (3.0 / np.pi) ** (1.0 / 3.0) * den ** (-2.0 / 3.0)
    s2 = 0.25 * (3.0 * np.pi**2) ** (-2.0 / 3.0) * gdg * den ** (-8.0 / 3.0)
    kappa, mu = 0.804, 0.066725 * np.pi**2 / 3.0
    Fx = 1.0 + kappa - kappa / (1.0 + mu / kappa * s2)
    ds2_dgn2 = 0.25 * (3.0 * np.pi**2) ** (-2.0 / 3.0) * den ** (-8.0 / 3.0)
    ds2_dn = -(8.0 / 3.0) * s2 / den
    dFx_ds2 = mu / (1.0 + mu / kappa * s2) ** 2
    E_x = qmean(Fx * eps * den) * ctx.vol
    df_dn_x = Fx * (deps_dn * den + eps) + dFx_ds2 * ds2_dn * eps * den
    df_dgn2_x = dFx_ds2 * ds2_dgn2 * eps * den

    # correlation
    eps_c, deps_dn_c = _pw92_eps_and_deriv(den)
    beta, gamma = 0.066725, float(1.0 - np.log(2.0)) / np.pi**2
    A = beta / gamma / (torch.exp(-eps_c / gamma) - 1.0 + 1e-30)
    dAdn = 1.0 / beta * A * A * torch.exp(-eps_c / gamma) * deps_dn_c
    t2 = ((1.0 / 16.0) * (np.pi / 3.0) ** (1.0 / 3.0)
          * gdg / (den ** (7.0 / 3.0) + 1e-30))
    dt2dn = -7.0 / 3.0 * t2 / den
    dt2dgn2 = (1.0 / 16.0) * (np.pi / 3.0) ** (1.0 / 3.0) / (
        den ** (7.0 / 3.0) + 1e-30)
    At2 = A * t2
    numer = 1.0 + At2
    denom = 1.0 + At2 + At2 * At2
    H = gamma * torch.log(1.0 + beta / gamma * t2 * (numer / denom))
    E_c = qmean((eps_c + H) * den) * ctx.vol
    numer2 = 1.0 + 2.0 * At2
    eH = torch.exp(-H / gamma)
    dHdn = beta * eH * (
        (dt2dn * numer2 + dAdn * t2 * t2) / denom
        - t2 * numer / denom**2 * (dt2dn * A * numer2 + dAdn * t2 * numer2))
    dH_dgn2 = beta * eH * (
        dt2dgn2 * numer2 / denom
        - At2 * numer / denom**2 * dt2dgn2 * numer2)
    df_dn_c = eps_c + H + den * (deps_dn_c + dHdn)
    df_dgn2_c = den * dH_dgn2

    # one combined divergence for both pieces
    gx, gy, gz = ctx.grads
    w = df_dgn2_x + df_dgn2_c
    aux = -2.0 * ctx.divergence(w * gx, w * gy, w * gz)
    return E_x + E_c, df_dn_x + df_dn_c + aux


_WT = 5.0 / 6.0


def _sum_vp(ctx, fns):
    E = torch.zeros((), dtype=torch.float64, device=ctx.den.device)
    pot = torch.zeros(ctx.shape, dtype=ctx.den.dtype, device=ctx.den.device)
    for f in fns:
        e, p = f(ctx)
        E = E + e
        pot = pot + p
    return E, pot


_DISPATCH = {
    "IonElectron": _vp_ion_electron,
    "Hartree": _vp_hartree,
    "ThomasFermi": _vp_thomas_fermi,
    "Weizsaecker": _vp_weizsaecker,
    "WangTeter": lambda ctx: _sum_vp(ctx, [
        _vp_weizsaecker, _vp_thomas_fermi,
        lambda c: _vp_nlkef(c, _WT, _WT)]),
    "PerdewBurkeErnzerhof": _vp_pbe,
}


def supported_terms(terms):
    """True iff every density-dependent term has a fused analytic form in
    this package."""
    return all(term_name(t) == "IonIon" or term_name(t) in _DISPATCH
               for t in terms)


def value_and_potential(terms, box_vecs, den, v_ext, N_elec=None):
    """Total (E, dE/dn) over the term list in ONE fused forward sweep.

    Raises KeyError for a term without a fused form (gate with
    :func:`supported_terms`)."""
    ctx = SpectralCtx(box_vecs, den, v_ext, N_elec=N_elec)
    fns = []
    for t in terms:
        nm = term_name(t)
        if nm == "IonIon":
            continue
        if nm not in _DISPATCH:
            raise KeyError(f"no fused analytic potential for term {nm!r}")
        fns.append(_DISPATCH[nm])
    return _sum_vp(ctx, fns)
