"""Fused analytic energy + functional-derivative (potential) evaluation.

PyTorch port of ``professad_tpu/models/potentials.py``, for every
functional of the JAX library that has a fused form there: IonElectron,
Hartree, ThomasFermi, Weizsaecker, the Wang-Teter family (WT, Perrot, SM,
WGC98 and ``WangTeterStyleFunctional``), WGC99, Foley-Madden, KGAP (a
keyword ``functools.partial`` binding E_gap), XWM (the bare function or a
keyword partial binding kappa), MGP, Huang-Carter and revHC, the tagged
YukawaGGA presets, vWGTF1/2, LKT, ``PauliGaussian``, the LDA
exchange-correlation family and PBE.  Each term contributes (E, dE/dn)
through a shared ``SpectralCtx``, so the density spectrum, the gradient
fields and the wavevectors are computed once per evaluation: one forward
sweep, no autograd graph, 13 3-D transforms for WT+PBE.  The dedicated
convolutions with a fixed real kernel (the vW Laplacian, the WT-family,
WGC99, KGAP, XWM, Foley-Madden linear and MGP kernels) go through
``grid.spectral_convolution``, i.e. the CUDA spectral-convolution kernel on
the card; the ladder terms' batched 4-D transforms go through
``torch.fft`` (``ops/fieldconv.py``).

Terms are dispatched by name (``_DISPATCH``), by the class of the module
that owns them (``_INSTANCE_DISPATCH``: a term may be the module itself or
its bound ``forward``), or as a keyword partial (``_partial_vp``).  The
trainable functionals' parameters are read detached: the fused sweep is a
constant of the functional's parameters, and no kernel that requires grad
reaches the CUDA kernel.  Opaque closures stay autograd-only.

E is accumulated in f64 (``qmean`` returns f64 for f32 fields); dE/dn is in
the working dtype, per grid point, NOT scaled by the quadrature weight.
One departure from the JAX package: PBE's potential takes 0 at points
where its f32 form overflows (the density at the f32 floor, see
``_vp_pbe``), where the JAX package's is NaN.
Other terms raise ``KeyError`` (``supported_terms`` returns False).
"""

import functools

import numpy as np
import torch

from ..ops.grid import (wavevecs, volume, qmean, wmean, safe_sqrt, rfftn,
                        irfftn, imul, spectral_convolution)
from ..ops.interp import _bracket
from ..ops.fieldconv import ladder_convolution, ladder_adjoint
from ..utils.naming import term_name
from .kinetic_local import TF_COEFF, _abs, _mean_density
from .kinetic_nonlocal import (G_inv_lind, G_inv_gap, WGC98_ALPHA, WGC98_BETA,
                               KGAP, XuWangMa, _kgap_exponents,
                               _stabilizer_fprime0, _wgc99_kernel,
                               _xwm_kernels)

__all__ = ["value_and_potential", "supported_terms", "SpectralCtx",
           "bind_sweep", "capturable_terms"]


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

    # Where the density nears the f32 floor (~1e-11) next to a finite
    # gradient, t2 and s2 overflow and the products above turn into
    # inf / inf, in the JAX package's form too; one such point would spread
    # NaN over the whole grid through the divergence.  Those points take
    # the vanishing-density limit 0; finite values are left untouched.
    w = _finite_or_zero(df_dgn2_x + df_dgn2_c)
    gx, gy, gz = ctx.grads
    aux = -2.0 * ctx.divergence(w * gx, w * gy, w * gz)
    return E_x + E_c, _finite_or_zero(df_dn_x + df_dn_c) + aux


def _finite_or_zero(x):
    return torch.where(torch.isfinite(x), x, torch.zeros((), dtype=x.dtype,
                                                         device=x.device))


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
    mu = _abs(params["mu"])
    beta = _abs(params["beta"])
    lamb = _abs(params["lamb"])
    sigma = _abs(params["sigma"])
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
    n0 = _mean_density(ctx.box_vecs, den)
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


def _detached(owner):
    return {k: v.detach() for k, v in owner.params.items()}


def _vp_mgp(ctx, owner):
    """MiGenovaPavanello: a fixed k-space kernel (given the detached,
    rounded n0), so the nonlocal potential is the symmetric-kernel closed
    form (5/3) n^{-1/6} conv(K, n^{5/6})."""
    den = ctx.den
    _, _, _, k2 = ctx.kvecs
    n0 = _mean_density(ctx.box_vecs, den)
    k_F = (3.0 * np.pi**2 * n0) ** (1.0 / 3.0)
    if owner.kernel is None:
        raise RuntimeError("MGP: call prepare() before the analytic path.")
    K = owner._kernel_ft(_detached(owner), den.dtype, k2, k_F)
    g = den ** (5.0 / 6.0)
    conv = spectral_convolution(K, g, ctx.shape)
    E_vw, pot_vw = _vp_weizsaecker(ctx)
    E_tf, pot_tf = _vp_thomas_fermi(ctx)
    E = E_vw + E_tf + qmean(g * conv) * ctx.vol
    pot = pot_vw + pot_tf + (5.0 / 3.0) * den ** (-1.0 / 6.0) * conv
    return E, pot


# ---------------- ladder terms: dense Hermite weights on the grid ----------

def _tangent_matrix(lad):
    """Catmull-Rom tangent operator T (m = T f) of the ladder, (n_xi,
    n_xi), as ``ops.interp._tangents`` computes the tangents."""
    n = lad.shape[0]
    inv = 1.0 / torch.diff(lad)
    T = lad.new_zeros((n, n))
    T[0, 0], T[0, 1] = -inv[0], inv[0]
    T[n - 1, n - 2], T[n - 1, n - 1] = -inv[-1], inv[-1]
    k = torch.arange(1, n - 1, device=lad.device)
    T[k, k - 1] += -0.5 * inv[k - 1]
    T[k, k] += 0.5 * inv[k - 1] - 0.5 * inv[k]
    T[k, k + 1] += 0.5 * inv[k]
    return T


def _ladder_weights(lad, xis, dtype):
    """Dense per-point ladder weights w and their xi-derivative dw, shapes
    (..., n_xi), such that K(r) = sum_j w_j(r) f_j(r) reproduces
    ``ops.interp.interpolate_kernel`` (Catmull-Rom tangents included) and
    dK/dxi = sum_j dw_j f_j."""
    lad = lad.to(dtype)
    T = _tangent_matrix(lad)
    idx = _bracket(lad, xis)
    x0 = lad[idx]
    dx = lad[idx + 1] - x0
    t = (xis - x0) / dx
    t2 = t * t
    t3 = t2 * t
    h00 = 1.0 - 3.0 * t2 + 2.0 * t3
    h10 = t - 2.0 * t2 + t3
    h01 = 3.0 * t2 - 2.0 * t3
    h11 = t3 - t2
    h00_t = -6.0 * t + 6.0 * t2
    h10_t = 1.0 - 4.0 * t + 3.0 * t2
    h01_t = 6.0 * t - 6.0 * t2
    h11_t = 3.0 * t2 - 2.0 * t

    jj = torch.arange(lad.shape[0], device=lad.device)
    e = idx[..., None]
    on0 = (jj == e).to(dtype)
    on1 = (jj == e + 1).to(dtype)
    T0 = T[idx]        # (..., n_xi) rows T[idx]
    T1 = T[idx + 1]
    w = (h00[..., None] * on0 + h01[..., None] * on1
         + dx[..., None] * (h10[..., None] * T0 + h11[..., None] * T1))
    dw = ((h00_t[..., None] * on0 + h01_t[..., None] * on1) / dx[..., None]
          + h10_t[..., None] * T0 + h11_t[..., None] * T1)
    return w, dw


def _vp_hc_family(ctx, owner, aux=None):
    """HuangCarter / RevisedHuangCarter fused potential.

    The functional derivative of T_NL = C int n^{8/3-b} K[n](r) / xi(r)^3
    has three pieces: (a) the direct density factors; (b) the adjoint of
    the field-dependent convolution, another ladder of convolutions with
    the Hermite weights on the output side (one batched 4-D forward
    transform + one inverse); (c) the xi(r) chain (dK/dxi from the weight
    derivatives and the -3/xi^4 factor), split into its local part and a
    divergence term for the |grad n|^2 dependence.  Needs the kernel slabs
    of ``owner.prepare`` (``aux``, else the owner's own)."""
    if aux is None:
        aux = owner.aux_arrays()
    if aux is None:
        raise RuntimeError(
            "HC analytic path: call prepare(box_vecs, den) first (the "
            "kernel-slab aux is required).")
    den = ctx.den
    dt = den.dtype
    lad = aux["ladder"].to(dt)
    W = aux["slabs"].to(dt)          # (m1, m2, m3, n_xi)
    params = _detached(owner)
    beta = float(params["beta"])
    C_HC = TF_COEFF * 8.0 * (3.0 * np.pi**2)

    gdg = ctx.gdg
    k_F = (3.0 * np.pi**2 * den) ** (1.0 / 3.0)

    if type(owner).__name__ == "HuangCarter":
        lamb = params["lamb"].to(dt)
        u = gdg / (den ** (8.0 / 3.0) + 1e-30)
        xis = 2.0 * k_F * (1.0 + lamb * u)
        dxi_dn = (xis / (3.0 * den)
                  - 2.0 * k_F * lamb * (8.0 / 3.0) * u / den)
        dxi_dgdg = 2.0 * k_F * lamb / (den ** (8.0 / 3.0) + 1e-30)
    else:  # RevisedHuangCarter
        a = params["a"].to(dt)
        b = params["b"].to(dt)
        c2 = 0.25 * (3.0 * np.pi**2) ** (-2.0 / 3.0)
        s2 = c2 * gdg * den ** (-8.0 / 3.0)
        F = 1.0 + a * s2 / (1.0 + b * s2)
        Fp = a / (1.0 + b * s2) ** 2
        xis = 2.0 * k_F * F
        dxi_dn = ((2.0 / 3.0) * k_F * F / den
                  + 2.0 * k_F * Fp * (-8.0 / 3.0) * s2 / den)
        dxi_dgdg = 2.0 * k_F * Fp * c2 * den ** (-8.0 / 3.0)

    # batched forward convolution: f_j(r) = irfftn(W_j * g^)(r)
    g = den ** beta
    conv = ladder_convolution(W, g, ctx.shape)

    w, dw = _ladder_weights(lad, xis, dt)
    K = torch.sum(w * conv, dim=-1)
    dK_dxi = torch.sum(dw * conv, dim=-1)

    xi3 = xis * xis * xis
    A = den ** (8.0 / 3.0 - beta)
    E_nl = C_HC * qmean(A * K / xi3) * ctx.vol

    # (a) direct density factor
    pot = C_HC * (8.0 / 3.0 - beta) * den ** (5.0 / 3.0 - beta) * K / xi3

    # (b) convolution adjoint: J = sum_j conv_j(F_out * w_j), one batched
    # forward + one inverse (the slabs are real and |k|-symmetric)
    B = (C_HC * A / xi3)[..., None] * w
    J = ladder_adjoint(W, B, ctx.shape)
    pot = pot + beta * den ** (beta - 1.0) * J

    # (c) xi chain: G = d/dxi of the integrand
    G = C_HC * A * (dK_dxi / xi3 - 3.0 * K / (xi3 * xis))
    pot = pot + G * dxi_dn
    gx, gy, gz = ctx.grads
    wdiv = G * dxi_dgdg
    pot = pot - 2.0 * ctx.divergence(wdiv * gx, wdiv * gy, wdiv * gz)

    E_vw, pot_vw = _vp_weizsaecker(ctx)
    E_tf, pot_tf = _vp_thomas_fermi(ctx)
    return E_vw + E_tf + E_nl, pot_vw + pot_tf + pot


def _quotient_chain(ctx, E_nl, pot_nl, f, fprime0=1.0):
    """E = vW + TF f(u), u = E_nl / (f'(0) TF), with both energies
    scalars: the potential by the scalar quotient rule, f'(u) by
    ``torch.func.grad`` of the stabilizer at the 0-d u."""
    dt = ctx.den.dtype
    E_vw, pot_vw = _vp_weizsaecker(ctx)
    E_tf, pot_tf = _vp_thomas_fermi(ctx)
    u = (E_nl / fprime0 / E_tf).to(dt)
    fu = f(u)
    fpu = torch.func.grad(f)(u)
    # du/dn = (E_nl' TF - E_nl TF') / (f'(0) TF^2), per point
    du = ((pot_nl * E_tf - E_nl * pot_tf).to(dt) / fprime0
          / (E_tf * E_tf).to(dt))
    E = E_vw + E_tf * fu
    pot = pot_vw + pot_tf * fu + E_tf.to(dt) * fpu * du
    return E, pot


def _vp_wtsf(ctx, owner, alpha, beta):
    """WangTeterStyleFunctional: the quotient chain over the WT-style
    nonlocal term, with the exponents ``alpha``, ``beta`` as host floats
    (read once per binding, ``_bind_wtsf``)."""
    E_nl, pot_nl = _vp_nlkef(ctx, alpha, beta)
    return _quotient_chain(ctx, E_nl, pot_nl, owner.f, owner.fprime0)


def _bind_wtsf(owner, aux):
    params = _detached(owner)
    alpha, beta = float(params["alpha"]), float(params["beta"])
    return lambda ctx: _vp_wtsf(ctx, owner, alpha, beta)


def _vp_wgc99(ctx, owner):
    """WangGovindCarter99: the second-order Taylor density-dependent
    kernel; the potential is the product / adjoint expansion of the six
    convolution terms (12 symmetric convolutions)."""
    den = ctx.den
    dt = den.dtype
    _, _, _, k2 = ctx.kvecs
    params = _detached(owner)
    n0 = _mean_density(ctx.box_vecs, den)
    n_ref = params["kappa"].to(dt) * n0
    k_F = (3.0 * np.pi**2 * n_ref) ** (1.0 / 3.0)
    eta = safe_sqrt(k2) / (2.0 * k_F)
    alpha = float(params["alpha"])
    beta = float(params["beta"])
    gamma = float(params["gamma"])
    w0, w1, w2 = _wgc99_kernel(eta, alpha, beta, gamma, owner.num_terms)
    T = 20.0 * n_ref ** (5.0 / 3.0 - alpha - beta)
    w0 = T * w0
    w1 = T * w1
    w2 = T * w2
    K1 = -eta * w1 / (6.0 * n_ref)
    K2 = (eta * eta * w2 + (7.0 - gamma) * eta * w1) / (36.0 * n_ref**2)
    K3 = (eta * eta * w2 + (1.0 + gamma) * eta * w1) / (36.0 * n_ref**2)

    theta = den - n_ref
    nb = den ** beta
    a = den ** alpha
    dnb = beta * den ** (beta - 1.0)
    da = alpha * den ** (alpha - 1.0)

    def cv(kern, field):
        return spectral_convolution(kern, field, ctx.shape)

    C0 = cv(w0, nb)
    C1 = cv(K1, nb)
    C1p = cv(K1, nb * theta)
    C2 = cv(K2, nb)
    C2p = cv(K2, 0.5 * nb * theta * theta)
    C3p = cv(K3, nb * theta)
    conv = (C0 + theta * C1 + C1p + 0.5 * theta * theta * C2 + C2p
            + theta * C3p)
    E_nl = TF_COEFF * qmean(a * conv) * ctx.vol

    at = a * theta
    pot = (da * conv                       # through a = n^alpha
           + cv(w0, a) * dnb               # term 1 adjoint
           + a * C1                        # term 2, theta factor
           + cv(K1, at) * dnb              # term 2 adjoint
           + cv(K1, a) * (dnb * theta + nb)        # term 3 adjoint
           + at * C2                       # term 4, theta^2 factor
           + cv(K2, 0.5 * at * theta) * dnb        # term 4 adjoint
           + cv(K2, a) * (0.5 * dnb * theta * theta + nb * theta)  # term 5
           + a * C3p                       # term 6, theta factor
           + cv(K3, at) * (dnb * theta + nb))      # term 6 adjoint
    pot = TF_COEFF * pot

    E_vw, pot_vw = _vp_weizsaecker(ctx)
    E_tf, pot_tf = _vp_thomas_fermi(ctx)
    return E_vw + E_tf + E_nl, pot_vw + pot_tf + pot


def _vp_kgap(ctx, E_gap, f):
    """KGAP: the quotient chain over the gapped-jellium response kernel;
    ``E_gap`` and ``f`` come from a keyword partial (any f with
    f(0) = 1)."""
    den = ctx.den
    fprime0 = _stabilizer_fprime0(f, "KGAP")
    alpha, beta = _kgap_exponents(E_gap)
    # KGAP's n0 is the rounded detached mean density (unlike WT's)
    n0 = _mean_density(ctx.box_vecs, den)

    eta, G_inv = G_inv_gap(ctx.box_vecs, den, E_gap)
    nz = eta != 0.0
    G_safe = torch.where(nz, G_inv, 1.0)
    kern = torch.where(nz, 1.0 / G_safe - 3.0 * eta * eta - 1.0, 0.0)
    kern = (5.0 / (9.0 * alpha * beta * n0 ** (alpha + beta - 5.0 / 3.0))
            * kern)

    g_b = den ** beta
    g_a = den ** alpha
    conv_b = spectral_convolution(kern, g_b, ctx.shape)
    conv_a = spectral_convolution(kern, g_a, ctx.shape)
    T_NL = TF_COEFF * qmean(g_a * conv_b) * ctx.vol
    dT_NL = TF_COEFF * (alpha * den ** (alpha - 1.0) * conv_b
                        + beta * den ** (beta - 1.0) * conv_a)
    return _quotient_chain(ctx, T_NL, dT_NL, f, fprime0)


_YUK_X0 = 40.0 / 27.0


def _yukawa_F(owner, y, s2, q, dt):
    """A tagged preset's F(y, s^2, q) and its closed-form partials
    (F, F_y, F_s2, F_q)."""
    x0 = _YUK_X0
    tag = owner._preset[0]
    if tag == "yuk1":
        return y, torch.ones_like(y), torch.zeros_like(y), torch.zeros_like(y)
    if tag == "yuk2":
        lin = 1.0 + x0 * (q - s2)
        return y * lin, lin, -y * x0, y * x0
    if tag == "yuk3":
        a = float(owner._preset[1])
        th = torch.tanh((a / 2.0) * (x0 * (q - s2)))
        T = 1.0 + (2.0 / a) * th
        Tp = 1.0 - th * th
        return y * T, T, -y * Tp * x0, y * Tp * x0
    if tag == "yuk4":
        a = float(owner._preset[1])
        th1 = torch.tanh((a / 2.0) * (-x0 * s2))
        T1 = 1.0 + (2.0 / a) * th1
        T1p = 1.0 - th1 * th1
        th2 = torch.tanh(x0 * q)         # T_2(2, x): (2/2) tanh(2x/2)
        T2 = 1.0 + th2
        T2p = 1.0 - th2 * th2
        return (y * T1 * T2, T1 * T2, y * T1p * (-x0) * T2,
                y * T1 * T2p * x0)
    if tag in ("yuk2beta", "yuk3beta"):
        params = _detached(owner)
        ap = params["alpha"].to(dt)
        bp = params["beta"].to(dt)
        G0 = ap**2 * (ap**2 - 60.0) / (108.0 * bp * (9.0 * bp - 10.0))
        g_c = x0 / bp - 4.0 / ap**2 * (bp - 1.0) * G0
        G = g_c * (q - bp * s2)
        if tag == "yuk2beta":
            return 1.0 - G0 + y * (G0 + G), G0 + G, -y * g_c * bp, y * g_c
        a = float(owner._preset[1])
        th = torch.tanh((a / 2.0) * (-G0 + y * (G0 + G)))
        Tp = 1.0 - th * th
        return (1.0 + (2.0 / a) * th, Tp * (G0 + G), -Tp * y * g_c * bp,
                Tp * y * g_c)
    raise KeyError(f"unknown YukawaGGA preset tag {tag!r}")


def _vp_yukawa(ctx, owner):
    """YukawaGGA preset fused potential.

    E = vW + int TF_ked F(y, s^2, q), y = c(n) u with u the spline
    field-dependent convolution of n^beta with the ladder of Yukawa
    kernels 4 pi / (k^2 + xi_j^2), xi = alpha k_F(r).  Five chains: (1)
    the direct TF_ked factor; (2) the prefactor c(n) ~ n^{2/3 - beta};
    (3) u's xi dependence by the Hermite-weight derivatives, d xi/dn =
    xi / (3 n); (4) u's convolution adjoint over g = n^beta, batched like
    the HC family's; (5) the s^2 (divergence) and q (Laplacian) chains of
    the preset's closed-form partials.  Tagged presets with spline=True
    only; needs the ladder of ``owner.prepare``."""
    if owner._preset is None or not owner.spline:
        raise KeyError(
            "YukawaGGA analytic potential: only the tagged presets with "
            "spline=True are supported; gate with supported_terms().")
    if owner.xi_sparse is None:
        raise RuntimeError(
            "YukawaGGA analytic path: call prepare(box_vecs, den) first "
            "(the static xi ladder is required).")

    den = ctx.den
    dt = den.dtype
    _, _, _, k2 = ctx.kvecs
    params = _detached(owner)
    alpha = float(params["alpha"])
    beta = float(params["beta"])
    lad = torch.as_tensor(owner.xi_sparse, dtype=dt, device=den.device)

    k_F = (3.0 * np.pi**2 * den) ** (1.0 / 3.0)
    xis = alpha * k_F
    g = den ** beta

    # ladder of constant-xi Yukawa kernels; one batched inverse transform
    W = 4.0 * np.pi / (k2[..., None] + lad * lad)
    conv = ladder_convolution(W, g, ctx.shape)
    w, dw = _ladder_weights(lad, xis, dt)
    u = torch.sum(w * conv, dim=-1)
    du_dxi = torch.sum(dw * conv, dim=-1)

    # y = c(n) u, c = 3 pi alpha^2 / (4 k_F n^{beta-1}) ~ n^{2/3 - beta}
    c = 3.0 * np.pi * alpha**2 / (4.0 * k_F * den ** (beta - 1.0))
    y = c * u

    c2 = 0.25 * (3.0 * np.pi**2) ** (-2.0 / 3.0)
    s2 = c2 * ctx.gdg * den ** (-8.0 / 3.0)
    lap_den = irfftn(-k2 * ctx.den_ft, ctx.shape)
    q = c2 * lap_den * den ** (-5.0 / 3.0)
    F, F_y, F_s2, F_q = _yukawa_F(owner, y, s2, q, dt)

    TF_ked = TF_COEFF * den ** (5.0 / 3.0)
    E_vw, pot_vw = _vp_weizsaecker(ctx)
    E = E_vw + qmean(TF_ked * F) * ctx.vol

    # (1) direct TF_ked factor
    pot = pot_vw + (5.0 / 3.0) * TF_COEFF * den ** (2.0 / 3.0) * F

    # (2) + (3): y's local chains (prefactor + xi), d xi/dn = xi/(3n)
    Ay = TF_ked * F_y
    pot = pot + Ay * ((2.0 / 3.0 - beta) * y / den
                      + c * du_dxi * xis / (3.0 * den))

    # (4) convolution adjoint over g = n^beta (batched, kernels symmetric)
    B = (Ay * c)[..., None] * w
    adj = ladder_adjoint(W, B, ctx.shape)
    pot = pot + beta * den ** (beta - 1.0) * adj

    # (5a) s^2 chain: local + divergence
    As2 = TF_ked * F_s2
    pot = pot + As2 * (-8.0 / 3.0) * s2 / den
    gx, gy, gz = ctx.grads
    wdiv = As2 * c2 * den ** (-8.0 / 3.0)
    pot = pot - 2.0 * ctx.divergence(wdiv * gx, wdiv * gy, wdiv * gz)

    # (5b) q chain: local + Laplacian adjoint
    Aq = TF_ked * F_q
    pot = pot + Aq * (-5.0 / 3.0) * q / den
    pot = pot + irfftn(-k2 * rfftn(Aq * c2 * den ** (-5.0 / 3.0)),
                       ctx.shape)
    return E, pot


def _vp_xwm(ctx, kappa=0.0):
    """XuWangMa for a given kappa (the bare function is kappa = 0)."""
    den = ctx.den
    _, _, _, k2 = ctx.kvecs
    n0 = _mean_density(ctx.box_vecs, den)
    # G_inv_lindhard's own (unrounded) detached mean density, as the
    # energy body computes it
    n0_lind = wmean(den).detach() * ctx.vol / ctx.vol
    k_F = (3.0 * np.pi**2 * n0_lind) ** (1.0 / 3.0)
    eta = safe_sqrt(k2) / (2.0 * k_F)
    G_inv = G_inv_lind(eta)
    K0, K1a, K1b = _xwm_kernels(eta, G_inv, n0, kappa)

    pa = kappa + 5.0 / 6.0
    pb = kappa + 11.0 / 6.0
    g0 = den ** pa
    g1 = den ** pb
    dg0 = pa * den ** (pa - 1.0)
    dg1 = pb * den ** (pb - 1.0)

    def cv(kern, field):
        return spectral_convolution(kern, field, ctx.shape)

    c00 = cv(K0, g0)
    c1a1 = cv(K1a, g1)
    c1b0 = cv(K1b, g0)
    E_nl = (qmean(g0 * c00) + qmean(g0 * c1a1) - qmean(g0 * c1b0)) * ctx.vol

    pot = (2.0 * dg0 * c00
           + dg0 * c1a1 + dg1 * cv(K1a, g0)
           - 2.0 * dg0 * c1b0)

    E_vw, pot_vw = _vp_weizsaecker(ctx)
    E_tf, pot_tf = _vp_thomas_fermi(ctx)
    return E_vw + E_tf + E_nl, pot_vw + pot_tf + pot


def _vp_fm(ctx, owner):
    """FoleyMadden: the cubic quadratic-response term's potential expands
    the cubic polynomial in the 11 convolution fields F_i, with all the
    adjoint convolutions combined in k-space (11 forward transforms and
    one inverse), plus the WT-style linear term and the stabilizer
    chain."""
    den = ctx.den
    _, _, _, k2 = ctx.kvecs
    params = _detached(owner)
    alpha = float(params["alpha"])
    beta = float(params["beta"])

    n0 = _mean_density(ctx.box_vecs, den)
    k_F = (3.0 * np.pi**2 * n0) ** (1.0 / 3.0)
    # G_inv_lindhard's own (unrounded) detached n0, as the energy does
    k_F_lind = (3.0 * np.pi**2 * wmean(den).detach()) ** (1.0 / 3.0)
    eta = safe_sqrt(k2) / (2.0 * k_F_lind)
    G_inv = G_inv_lind(eta)
    q = 2.0 * eta

    kernel = (TF_COEFF * 5.0
              / (9.0 * alpha**2 * n0 ** (2.0 * alpha - 5.0 / 3.0))
              * (1.0 / G_inv - 3.0 * eta * eta - 1.0))
    d_a = den ** alpha - n0 ** alpha
    conv = spectral_convolution(kernel, d_a, ctx.shape)
    NL1 = qmean(d_a * conv) * ctx.vol
    dNL1 = 2.0 * alpha * den ** (alpha - 1.0) * conv

    K_delta = (alpha**2 * n0 ** (2.0 * alpha - 1.0) / 18.0 * k_F**2
               * (6.0 * alpha - 5.0) * kernel)
    f1, f2, f3, f4, f5, f6, f7 = owner._piecewise_fits(q)
    nz = q != 0.0
    f1_over_q2 = torch.where(nz, f1 / torch.where(nz, q, 1.0) ** 2, 0.4)
    kerns = [f1, f1 * q**4, f1_over_q2, f1 * q**2, f2 * f3, f2, f5, f4,
             f6, f7, K_delta]

    delta_nb = den ** beta - n0 ** beta
    dnb_ft = rfftn(delta_nb)
    F1, F2, F3, F4, F5, F6, F7, F8, F9, F10, F11 = [
        irfftn(kern * dnb_ft, ctx.shape) for kern in kerns]
    aux = (-13.0 / 540.0 * F1**3 - F2 * F3**2 / 40.0 + F4 * F3 * F1 / 20.0
           + 3.0 * F5 * F6**2 + 3.0 * F7 * F8**2 + 3.0 * F9 * F10**2
           + 3.0 * F11 * delta_nb**2)
    c2 = -k_F**2 / beta**3 / n0 ** (3.0 * beta - 1.0)
    NL2 = c2 * qmean(aux) * ctx.vol

    # d aux / d F_i, then one combined k-space adjoint
    dF = [-13.0 / 180.0 * F1**2 + F4 * F3 / 20.0,       # F1
          -F3**2 / 40.0,                                 # F2
          -F2 * F3 / 20.0 + F4 * F1 / 20.0,              # F3
          F3 * F1 / 20.0,                                # F4
          3.0 * F6**2,                                   # F5
          6.0 * F5 * F6,                                 # F6
          3.0 * F8**2,                                   # F7
          6.0 * F7 * F8,                                 # F8
          3.0 * F10**2,                                  # F9
          6.0 * F9 * F10,                                # F10
          3.0 * delta_nb**2]                             # F11
    acc = kerns[0] * rfftn(dF[0])
    for kern, g in zip(kerns[1:], dF[1:]):
        acc = acc + kern * rfftn(g)
    adj = irfftn(acc, ctx.shape) + 6.0 * F11 * delta_nb
    dNL2 = c2 * adj * beta * den ** (beta - 1.0)
    return _quotient_chain(ctx, NL1 + NL2, dNL1 + dNL2, owner.f)


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

# trainable functionals, dispatched by the class of the owning module:
# bind(owner, aux) -> (ctx -> (E, pot)), with aux the term's entry of
# System's term-aux list; a binder reads the host scalars its term needs
_INSTANCE_DISPATCH = {
    "PauliGaussian": lambda owner, aux: lambda ctx: _vp_pauli_gaussian(
        ctx, _detached(owner)),
    "WangTeterStyleFunctional": _bind_wtsf,
    "MiGenovaPavanello": lambda owner, aux: lambda ctx: _vp_mgp(ctx, owner),
    "HuangCarter": lambda owner, aux: lambda ctx: _vp_hc_family(ctx, owner,
                                                                aux),
    "RevisedHuangCarter": lambda owner, aux: lambda ctx: _vp_hc_family(
        ctx, owner, aux),
    "WangGovindCarter99": lambda owner, aux: lambda ctx: _vp_wgc99(ctx,
                                                                   owner),
    "FoleyMadden": lambda owner, aux: lambda ctx: _vp_fm(ctx, owner),
    "YukawaGGA": lambda owner, aux: lambda ctx: _vp_yukawa(ctx, owner),
}

# the trainable functionals whose bound sweep reads nothing to the host
_CAPTURABLE_INSTANCES = ("PauliGaussian", "WangTeterStyleFunctional")


def _owner(t):
    """The module a term belongs to: ``__self__`` of a bound method
    (``functional.forward``), else the term itself."""
    return getattr(t, "__self__", t)


def _partial_vp(t):
    """(ctx -> (E, pot)) for a keyword ``functools.partial`` of KGAP (E_gap
    and optionally f) or XuWangMa (kappa), else None.  Positional bindings
    are rejected: they would shift (box_vecs, den)."""
    if not isinstance(t, functools.partial) or t.args:
        return None
    kw = dict(t.keywords or {})
    if t.func is KGAP and "E_gap" in kw and set(kw) <= {"E_gap", "f"}:
        E_gap = float(kw["E_gap"])
        f = kw.get("f", lambda x: 1.0 + x)
        return lambda ctx: _vp_kgap(ctx, E_gap, f)
    if t.func is XuWangMa and set(kw) <= {"kappa"}:
        kappa = float(kw.get("kappa", 0.0))
        return lambda ctx: _vp_xwm(ctx, kappa)
    return None


def _term_vp(t, aux):
    """(ctx -> (E, pot)) for one term, or None if it has no fused form
    (IonIon has none and needs none)."""
    if t is XuWangMa:
        return _vp_xwm
    pfn = _partial_vp(t)
    if pfn is not None:
        return pfn
    owner = _owner(t)
    cls = type(owner).__name__
    if cls == "YukawaGGA" and (owner._preset is None or not owner.spline):
        return None
    if cls in _INSTANCE_DISPATCH:
        return _INSTANCE_DISPATCH[cls](owner, aux)
    return _DISPATCH.get(term_name(t))


def supported_terms(terms):
    """True iff every density-dependent term has a fused analytic form:
    the functionals of ``_DISPATCH`` and ``_INSTANCE_DISPATCH`` (YukawaGGA
    only for its tagged presets with spline=True), the bare XuWangMa and
    the keyword partials of KGAP and XuWangMa."""
    return all(term_name(t) == "IonIon" or _term_vp(t, None) is not None
               for t in terms)


def capturable_terms(terms):
    """True iff the bound sweep over ``terms`` (:func:`bind_sweep`) reads
    nothing to the host, so a CUDA graph may capture it: every term of
    ``_DISPATCH`` and the trainable functionals of
    ``_CAPTURABLE_INSTANCES``.  The keyword partials, XuWangMa and the
    other trainable functionals read host scalars or tables in every
    evaluation."""
    for t in terms:
        if term_name(t) == "IonIon":
            continue
        if t is XuWangMa or isinstance(t, functools.partial):
            return False
        cls = type(_owner(t)).__name__
        if cls in _INSTANCE_DISPATCH:
            if cls not in _CAPTURABLE_INSTANCES:
                return False
        elif term_name(t) not in _DISPATCH:
            return False
    return True


def bind_sweep(terms, aux=None):
    """The fused sweep over the term list as a function
    ``(box_vecs, den, v_ext, N_elec=None) -> (E, dE/dn)``, with the host
    scalars of the terms (a trainable functional's exponents) read now,
    once, and not in every evaluation.  Bind again after the parameters
    change.  ``aux`` and the KeyError as in :func:`value_and_potential`."""
    fns = []
    for i, t in enumerate(terms):
        nm = term_name(t)
        if nm == "IonIon":
            continue
        fn = _term_vp(t, None if aux is None else aux[i])
        if fn is None:
            raise KeyError(f"no fused analytic potential for term {nm!r}")
        fns.append(fn)

    def sweep(box_vecs, den, v_ext, N_elec=None):
        return _sum_vp(SpectralCtx(box_vecs, den, v_ext, N_elec=N_elec), fns)
    return sweep


def value_and_potential(terms, box_vecs, den, v_ext, N_elec=None, aux=None):
    """Total (E, dE/dn) over the term list in ONE fused forward sweep.

    ``aux``: the per-term list of ``System._collect_term_aux`` (the
    kernel slabs the ladder terms' ``prepare`` hoisted), or None.  Raises
    KeyError for a term without a fused form (gate with
    :func:`supported_terms`)."""
    return bind_sweep(terms, aux)(box_vecs, den, v_ext, N_elec)
