"""Fused analytic energy + functional-derivative (potential) evaluation.

PyTorch port of ``professad_tpu/models/potentials.py`` for every functional
that needs no ladder, ODE table or spline: IonElectron, Hartree,
ThomasFermi, Weizsaecker, the Wang-Teter family (WT, Perrot, SM, WGC98 and
``WangTeterStyleFunctional``), vWGTF1/2, LKT, ``PauliGaussian``, the LDA
exchange-correlation family and PBE.  Each term contributes (E, dE/dn)
through a shared ``SpectralCtx``, so the density spectrum, the gradient
fields and the wavevectors are computed once per evaluation: one forward
sweep, no autograd graph, 13 3-D transforms for WT+PBE.  The dedicated
convolutions (the vW Laplacian and the WT-family kernel with alpha = beta)
go through ``grid.spectral_convolution``, i.e. the CUDA spectral-convolution
kernel on the card.

Terms are dispatched by name (``_DISPATCH``), or, for the trainable
functionals, by the class of the module that owns them
(``_INSTANCE_DISPATCH``): a term may be the module itself or its bound
``forward``.  Their parameters are read detached: the fused sweep is a
constant of the functional's parameters.

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
from .kinetic_nonlocal import G_inv_lind, WGC98_ALPHA, WGC98_BETA

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


def _vp_gga_kinetic(ctx, F_and_dF, clamp_s=None):
    """Shared machinery of the GGA Pauli terms: E = vW + qmean(TF_ked F(s)),
    pot = vW' + F TF' + dF/ds ds/dn TF_ked - div(...), one combined
    divergence."""
    den = ctx.den
    abs_grad = safe_sqrt(ctx.gdg)
    c_s = 0.5 * (3.0 * np.pi**2) ** (-1.0 / 3.0)
    s = c_s * abs_grad * den ** (-4.0 / 3.0)
    if clamp_s is not None:
        clamped = s >= clamp_s
        s = torch.clamp(s, max=clamp_s)
    F, dF = F_and_dF(s)
    if clamp_s is not None:
        dF = torch.where(clamped, 0.0, dF)  # the clamp kills the chain
    TF_ked = TF_COEFF * den ** (5.0 / 3.0)
    E_vw, pot_vw = _vp_weizsaecker(ctx)
    E = E_vw + qmean(TF_ked * F) * ctx.vol

    dsdn = c_s * (-4.0 / 3.0) * abs_grad * den ** (-7.0 / 3.0)
    dsdgradn = c_s * den ** (-4.0 / 3.0)
    term1 = pot_vw + F * (5.0 / 3.0) * TF_COEFF * den ** (2.0 / 3.0)
    term2 = dF * dsdn * TF_ked
    gx, gy, gz = ctx.grads
    nzg = abs_grad > 0
    w = torch.where(nzg, dF * dsdgradn * TF_ked
                    / torch.where(nzg, abs_grad, 1.0), 0.0)
    term3 = -ctx.divergence(w * gx, w * gy, w * gz)
    return E, term1 + term2 + term3


def _vp_lkt(ctx):
    def F_and_dF(s):
        F = 1.0 / torch.cosh(1.3 * s)
        return F, -1.3 * torch.tanh(1.3 * s) * F
    return _vp_gga_kinetic(ctx, F_and_dF, clamp_s=100.0)


def _vp_pauli_gaussian(ctx, params):
    """PauliGaussian family with the q (reduced-Laplacian) terms:
    F = e^{-mu s^2} + beta q^2 - lamb q s^2 + sigma s^4."""
    den = ctx.den
    _, _, _, k2 = ctx.kvecs
    gdg = ctx.gdg
    mu = torch.abs(params["mu"])
    beta = torch.abs(params["beta"])
    lamb = torch.abs(params["lamb"])
    sigma = torch.abs(params["sigma"])
    c2 = 0.25 * (3.0 * np.pi**2) ** (-2.0 / 3.0)
    s2 = c2 * gdg * den ** (-8.0 / 3.0)
    lap_den = irfftn(-k2 * ctx.den_ft, ctx.shape)
    q = c2 * lap_den * den ** (-5.0 / 3.0)
    expms2 = torch.exp(-mu * s2)
    F = expms2 + beta * q * q - lamb * q * s2 + sigma * s2 * s2
    TF_ked = TF_COEFF * den ** (5.0 / 3.0)
    E_vw, pot_vw = _vp_weizsaecker(ctx)
    E = E_vw + qmean(TF_ked * F) * ctx.vol

    dF_ds2 = -mu * expms2 - lamb * q + 2.0 * sigma * s2
    dF_dq = 2.0 * beta * q - lamb * s2
    ds2_dn = -(8.0 / 3.0) * s2 / den
    ds2_dgn2 = c2 * den ** (-8.0 / 3.0)
    dq_dn = -(5.0 / 3.0) * q / den
    dq_dlapn = c2 * den ** (-5.0 / 3.0)

    pot = (pot_vw + F * (5.0 / 3.0) * TF_COEFF * den ** (2.0 / 3.0)
           + (dF_ds2 * ds2_dn + dF_dq * dq_dn) * TF_ked)
    gx, gy, gz = ctx.grads
    w = dF_ds2 * ds2_dgn2 * TF_ked
    pot = pot - 2.0 * ctx.divergence(w * gx, w * gy, w * gz)
    # q enters through the Laplacian: + lap(dF/dq dq/dlap TF_ked)
    pot = pot + irfftn(-k2 * rfftn(dF_dq * dq_dlapn * TF_ked), ctx.shape)
    return E, pot


def _vp_vwgtf(ctx, which):
    """vWGTF1/2: d = n / n0 with n0 from the rounded, detached electron
    count (so n0 carries no density gradient), enhancement G(d) on TF."""
    den = ctx.den
    n0 = torch.round(wmean(den).detach() * ctx.vol) / ctx.vol
    d = den / n0
    if which == 1:
        G = 0.9892 * d ** (-1.2994)
        dG_dd = 0.9892 * (-1.2994) * d ** (-2.2994)
    else:
        u = 5.7001 * d ** 0.2563 - 5.7001
        ELF = 0.5 * (1.0 + torch.tanh(u))
        G = torch.sqrt(1.0 / ELF - 1.0)
        sech2 = 1.0 - torch.tanh(u) ** 2
        dELF_dd = 0.5 * sech2 * 5.7001 * 0.2563 * d ** (-0.7437)
        pos = G > 0
        dG_dELF = torch.where(pos, -1.0 / (2.0 * torch.where(pos, G, 1.0)
                                           * ELF * ELF), 0.0)
        dG_dd = dG_dELF * dELF_dd
    TF_ked = TF_COEFF * den ** (5.0 / 3.0)
    E_vw, pot_vw = _vp_weizsaecker(ctx)
    E = E_vw + qmean(G * TF_ked) * ctx.vol
    pot = (pot_vw + dG_dd / n0 * TF_ked
           + G * (5.0 / 3.0) * TF_COEFF * den ** (2.0 / 3.0))
    return E, pot


def _vp_pz_correlation(ctx):
    den = ctx.den
    gamma, beta1, beta2 = -0.1423, 1.0529, 0.3334
    A, B, C, D = 0.0311, -0.048, 0.002, -0.0116
    rs = (3.0 / (4.0 * np.pi) / den) ** (1.0 / 3.0)
    log_rs = torch.log(rs)
    eps_hi = A * log_rs + B + C * rs * log_rs + D * rs
    srs = torch.sqrt(rs)
    eps_lo = gamma / (1.0 + beta1 * srs + beta2 * rs)
    E = qmean(torch.where(rs < 1.0, eps_hi, eps_lo) * den) * ctx.vol
    pot_hi = (log_rs * (A + 2.0 / 3.0 * C * rs) + (B - A / 3.0)
              + rs / 3.0 * (2.0 * D - C))
    pot_lo = (gamma * (1.0 + 7.0 / 6.0 * beta1 * srs + 4.0 / 3.0 * beta2 * rs)
              / (1.0 + beta1 * srs + beta2 * rs) ** 2)
    return E, torch.where(rs < 1.0, pot_hi, pot_lo)


def _vp_chachiyo_correlation(ctx):
    den = ctx.den
    a = float(np.log(2.0) - 1.0) / (2.0 * np.pi**2)
    b = 20.4562557
    rs = (3.0 / (4.0 * np.pi) / den) ** (1.0 / 3.0)
    inner = 1.0 + b / rs + b / rs**2
    eps = a * torch.log(inner)
    E = qmean(eps * den) * ctx.vol
    deps_drs = a / inner * (-b / rs**2 - 2.0 * b / rs**3)
    drs_dn = ((3.0 / (4.0 * np.pi)) ** (1.0 / 3.0) * (-1.0 / 3.0)
              * den ** (-4.0 / 3.0))
    return E, deps_drs * drs_dn * den + eps


def _vp_lda_exchange(ctx):
    den = ctx.den
    E = (-(3.0 / 4.0) * (3.0 / np.pi) ** (1.0 / 3.0)
         * qmean(den ** (4.0 / 3.0)) * ctx.vol)
    pot = -(3.0 / np.pi) ** (1.0 / 3.0) * den ** (1.0 / 3.0)
    return E, pot


def _vp_pw_correlation(ctx):
    eps, deps_dn = _pw92_eps_and_deriv(ctx.den)
    E = qmean(eps * ctx.den) * ctx.vol
    return E, deps_dn * ctx.den + eps


def _vp_wtsf(ctx, owner):
    """WangTeterStyleFunctional: E = vW + TF f(u), u = T_NL / (f'(0) TF),
    both energies scalars, so the potential follows from the scalar
    quotient rule; f'(u) is ``torch.func.grad`` of the stabilizer at the
    0-d u (no graph reaches the solver)."""
    dt = ctx.den.dtype
    alpha = float(owner.params["alpha"].detach())
    beta = float(owner.params["beta"].detach())
    E_vw, pot_vw = _vp_weizsaecker(ctx)
    E_tf, pot_tf = _vp_thomas_fermi(ctx)
    E_nl, pot_nl = _vp_nlkef(ctx, alpha, beta)
    u = (E_nl / owner.fprime0 / E_tf).to(dt)
    fu = owner.f(u)
    fpu = torch.func.grad(owner.f)(u)
    # du/dn = (T_NL' TF - T_NL TF') / (f'(0) TF^2), per point
    du = ((pot_nl * E_tf - E_nl * pot_tf).to(dt) / owner.fprime0
          / (E_tf * E_tf).to(dt))
    E = E_vw + E_tf * fu
    pot = pot_vw + pot_tf * fu + E_tf.to(dt) * fpu * du
    return E, pot


_WT = 5.0 / 6.0


def _wt_family(alpha, beta):
    return lambda ctx: _sum_vp(ctx, [
        _vp_weizsaecker, _vp_thomas_fermi,
        lambda c: _vp_nlkef(c, alpha, beta)])


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
    "WangTeter": _wt_family(_WT, _WT),
    "Perrot": _wt_family(1.0, 1.0),
    "SmargiassiMadden": _wt_family(0.5, 0.5),
    "WangGovindCarter98": _wt_family(WGC98_ALPHA, WGC98_BETA),
    "PerdewBurkeErnzerhof": _vp_pbe,
    "lda_exchange": _vp_lda_exchange,
    "perdew_wang_correlation": _vp_pw_correlation,
    "PerdewWang": lambda ctx: _sum_vp(ctx, [_vp_lda_exchange,
                                            _vp_pw_correlation]),
    "LuoKarasievTrickey": _vp_lkt,
    "vWGTF1": lambda ctx: _vp_vwgtf(ctx, 1),
    "vWGTF2": lambda ctx: _vp_vwgtf(ctx, 2),
    "perdew_zunger_correlation": _vp_pz_correlation,
    "chachiyo_correlation": _vp_chachiyo_correlation,
    "PerdewZunger": lambda ctx: _sum_vp(ctx, [_vp_lda_exchange,
                                              _vp_pz_correlation]),
    "Chachiyo": lambda ctx: _sum_vp(ctx, [_vp_lda_exchange,
                                          _vp_chachiyo_correlation]),
}

# trainable functionals, dispatched by the class of the owning module
_INSTANCE_DISPATCH = {
    "PauliGaussian": lambda ctx, owner: _vp_pauli_gaussian(
        ctx, {k: v.detach() for k, v in owner.params.items()}),
    "WangTeterStyleFunctional": _vp_wtsf,
}


def _owner_class(t):
    """Class name of the module a term belongs to: ``__self__`` of a bound
    method (``functional.forward``), else the term itself."""
    return type(getattr(t, "__self__", t)).__name__


def supported_terms(terms):
    """True iff every density-dependent term has a fused analytic form in
    this package."""
    return all(term_name(t) == "IonIon" or term_name(t) in _DISPATCH
               or _owner_class(t) in _INSTANCE_DISPATCH for t in terms)


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
        cls = _owner_class(t)
        if cls in _INSTANCE_DISPATCH:
            owner = getattr(t, "__self__", t)
            fns.append(lambda c, fn=_INSTANCE_DISPATCH[cls], o=owner:
                       fn(c, o))
        elif nm in _DISPATCH:
            fns.append(_DISPATCH[nm])
        else:
            raise KeyError(f"no fused analytic potential for term {nm!r}")
    return _sum_vp(ctx, fns)
