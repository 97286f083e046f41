"""Pencil-decomposed distributed 3-D real FFT and the distributed energy,
gradient and solver built on it.

PyTorch counterpart of ``professad_tpu/parallel/pfft.py``.  The JAX
functions run inside ``shard_map`` and name a mesh axis; these run on every
rank of a ``torch.distributed`` process group (SPMD, one process per
device) and take the group:

  real space: x split along axis 0          local (n0/P, n1, n2)
    1. local rfft along axis 2, fft along axis 1
    2. one all_to_all: axis-0 slabs -> axis-1 pencils
    3. local fft along axis 0
  k space: X split along axis 1             local (n0, n1/P, m2)

The inverse reverses the pipeline.  The local transforms are ``torch.fft``
calls (cuFFT on the card), as they are XLA FFTs in the JAX package: the
fused spectral-convolution kernel treats its input as a whole periodic
grid, so no pencil path calls it.  ``pwavevecs`` builds this rank's
k-pencil, so spectral kernels are evaluated on the local slab and nothing is
gathered.  Reductions are ``psum``s in the graph, so every rank holds the
same energy; autograd of it follows the rule of ``parallel/collectives.py``
(each rank differentiates its share E / P).
"""

import numpy as np
import torch

from ..ops.grid import inv3x3, _freq_indices, _colsum_mean64, volume
from ..utils.naming import term_name
from .collectives import (all_to_all, psum, rank_share, axis_index,
                          axis_size)

__all__ = ["prfftn", "pirfftn", "prfftn_dc", "pirfftn_dc", "pwavevecs",
           "pconv", "pconv_dc", "pmean", "pqmean", "pwmean", "penergy_wt_pbe",
           "pvalue_and_potential_wt_pbe", "pchi_value_and_grad",
           "pchi_value_and_grad_analytic", "penergy_terms",
           "aux_pencil_specs", "pchi_value_and_grad_terms",
           "pencil_tpgd_minimize"]


def _origin(t):
    i0 = torch.zeros(1, dtype=torch.long, device=t.device)
    return (i0, i0, i0)


def prfftn(x_local, group):
    """Distributed rfftn over the grid axes 0-2: the local real slab
    (n0/P, n1, n2[, ...]) -> the local k-pencil (n0, n1/P, m2[, ...]) of
    the global half spectrum.  Trailing axes (a ladder) ride along."""
    X = torch.fft.rfft(x_local, dim=2)
    X = torch.fft.fft(X, dim=1)
    X = all_to_all(X, 1, 0, group)
    return torch.fft.fft(X, dim=0)


def pirfftn(X_local, shape, group):
    """Inverse of :func:`prfftn`: the local real slab (n0/P, n1, n2[, ...]);
    only ``shape[2]`` is read."""
    X = torch.fft.ifft(X_local, dim=0)
    X = all_to_all(X, 0, 1, group)
    X = torch.fft.ifft(X, dim=1)
    return torch.fft.irfft(X, n=int(shape[2]), dim=2)


def _n_glob(local, group):
    return local.shape[0] * axis_size(group) * local.shape[1] * local.shape[2]


def prfftn_dc(x_local, group):
    """:func:`prfftn` with the f32 DC split of ``ops.grid.rfftn``: the
    global mean (per trailing slab) is taken out before the transform and
    the k = 0 coefficient set from it exactly.  That coefficient lives on
    the first rank's pencil only.  Other dtypes take plain :func:`prfftn`."""
    if x_local.dtype != torch.float32:
        return prfftn(x_local, group)
    n = _n_glob(x_local, group)
    xm = psum(torch.sum(x_local, dim=(0, 1, 2)), group) / n
    X = prfftn(x_local - xm, group)
    if axis_index(group) == 0:
        dc = (xm * n).to(X.dtype).unsqueeze(0)
        X = torch.index_put(X, _origin(X), dc, accumulate=True)
    return X


def pirfftn_dc(X_local, shape, group):
    """Inverse of :func:`prfftn_dc`: a complex64 spectrum's DC coefficient
    (on the first rank) is carried around the transform as an exact
    uniform shift; other dtypes take plain :func:`pirfftn`."""
    if X_local.dtype != torch.complex64:
        return pirfftn(X_local, shape, group)
    if axis_index(group) == 0:
        own = X_local[0, 0, 0].real
        X_local = torch.index_put(X_local, _origin(X_local),
                                  torch.zeros_like(X_local[:1, 0, 0]))
    else:
        own = torch.zeros_like(X_local[0, 0, 0].real)
    dc = psum(own, group)
    y = pirfftn(X_local, shape, group)
    return y + dc / _n_glob(y, group)


def pwavevecs(box_vecs, shape, group):
    """Wavevectors (kx, ky, kz, k2) on this rank's k-pencil of the GLOBAL
    grid ``shape``: ``ops.grid.wavevecs`` (with its Nyquist sign rule)
    restricted to axis-1 block ``axis_index``; differentiable with respect
    to ``box_vecs``."""
    b = 2.0 * np.pi * inv3x3(box_vecs.T)
    nA, nB, nC = _freq_indices(tuple(shape), box_vecs.dtype, box_vecs.device)
    chunk = shape[1] // axis_size(group)
    nB = nB.narrow(1, axis_index(group) * chunk, chunk)
    kx = nA * b[0, 0] + nB * b[1, 0] + nC * b[2, 0]
    ky = nA * b[0, 1] + nB * b[1, 1] + nC * b[2, 1]
    kz = nA * b[0, 2] + nB * b[1, 2] + nC * b[2, 2]
    return kx, ky, kz, kx * kx + ky * ky + kz * kz


def pconv_dc(K_local, x_local, shape, group):
    """Distributed irfftn(K rfftn(x)) for a real half-spectrum kernel on
    this rank's k-pencil, with the f32 DC split of the serial spectral
    convolution (``ops.spectral_conv``): the pencil transforms convolve
    x - m, m the compensated global mean (:func:`pwmean`), and K(0) m is
    added back; K(0) lives on the first rank's pencil.  The pencil path's
    dedicated convolutions (``ops.grid.spectral_convolution`` under
    ``pencil_mode``, the solver's preconditioner) take it, so their f32
    rounding follows the serial path's.  Other dtypes: plain transforms."""
    if x_local.dtype != torch.float32:
        return pirfftn(K_local * prfftn(x_local, group), shape, group)
    m = pwmean(x_local, group)
    y = pirfftn(K_local * prfftn(x_local - m, group), shape, group)
    k0 = (K_local[0, 0, 0] if axis_index(group) == 0
          else torch.zeros_like(K_local[0, 0, 0]))
    return y + psum(k0, group) * m


def pconv(x_local, kern_fn, box_vecs, shape, group):
    """Distributed irfftn(kern(k2) rfftn(x)); ``kern_fn(k2 pencil)`` gives
    the real kernel on this rank's k-pencil."""
    _, _, _, k2 = pwavevecs(box_vecs, shape, group)
    return pirfftn(kern_fn(k2) * prfftn(x_local, group), shape, group)


# ------------------------------- means -------------------------------------

def pmean(x_local, group):
    """Global mean of an axis-0-split field: a ``psum`` in the graph."""
    return psum(torch.sum(x_local), group) / (x_local.numel()
                                               * axis_size(group))


def pqmean(x_local, group):
    """Distributed ``ops.grid.qmean``, for terminal energies: f32 fields
    sum in f32 over 512 columns, combine in f64 and take one f64
    all-reduce, an f64 scalar; others are :func:`pmean`."""
    if x_local.dtype != torch.float32:
        return pmean(x_local, group)
    n = x_local.numel() * axis_size(group)
    return psum(_colsum_mean64(x_local) * (x_local.numel() / n), group)


def pwmean(x_local, group):
    """Distributed ``ops.grid.wmean``, for means that feed array arithmetic
    (N_tilde, mu): the value of :func:`pqmean` cast back to the working
    dtype, the gradient of :func:`pmean` (the ``psum`` stays in the graph,
    the linear rule of the JAX package's custom_jvp)."""
    plain = pmean(x_local, group)
    if x_local.dtype != torch.float32:
        return plain
    with torch.no_grad():
        n = x_local.numel() * axis_size(group)
        acc = psum(_colsum_mean64(x_local) * (x_local.numel() / n), group)
    return plain + (acc.to(plain.dtype) - plain).detach()


# ------------------- the hand-fused WT + PBE energy bodies ------------------

def _wt_kernel(k2, n0):
    from ..models.kinetic_nonlocal import G_inv_lind
    from ..ops.grid import safe_sqrt
    alpha = beta = 5.0 / 6.0
    k_F = (3.0 * np.pi ** 2 * n0) ** (1.0 / 3.0)
    eta = safe_sqrt(k2) / (2.0 * k_F)
    return (5.0 / (9.0 * alpha * beta * n0 ** (alpha + beta - 5.0 / 3.0))
            * (1.0 / G_inv_lind(eta) - 3.0 * eta * eta - 1.0))


def _igrad(ki, den_ft, shape, group):
    return pirfftn(torch.complex(-ki * den_ft.imag, ki * den_ft.real),
                   shape, group)


def penergy_wt_pbe(box_vecs, den_local, v_ext_local, shape, group):
    """IonElectron + Hartree + vW + TF + WangTeter + PBE, written out on
    pencil transforms: the distributed reference body of the benchmark term
    set (every transform one all_to_all, every reduction a psum)."""
    from ..models.kinetic_local import TF_COEFF
    from ..models.xc import _pbe_exchange_density, _pbe_correlation_density
    vol = volume(box_vecs)
    kx, ky, kz, k2 = pwavevecs(box_vecs, shape, group)
    den_ft = prfftn(den_local, group)
    E = pqmean(den_local * v_ext_local, group) * vol
    nz = k2 != 0
    coul = torch.where(nz, 4.0 * np.pi / torch.where(nz, k2, 1.0), 0.0)
    v_h = pirfftn(coul * den_ft, shape, group)
    E = E + 0.5 * pqmean(den_local * v_h, group) * vol
    gx, gy, gz = (_igrad(k, den_ft, shape, group) for k in (kx, ky, kz))
    gdg = gx * gx + gy * gy + gz * gz
    sqrt_den = torch.sqrt(den_local)
    lap_den = pirfftn(-k2 * den_ft, shape, group)
    lap_sqrt = pirfftn(-k2 * prfftn(sqrt_den, group), shape, group)
    E = E + pqmean(0.25 * lap_den - 0.5 * sqrt_den * lap_sqrt, group) * vol
    E = E + TF_COEFF * pqmean(den_local ** (5.0 / 3.0), group) * vol
    alpha = beta = 5.0 / 6.0
    # the electron NUMBER is a constant; n0 = N / vol keeps its volume
    n0 = (pmean(den_local, group) * vol).detach() / vol
    conv = pirfftn(_wt_kernel(k2, n0)
                   * prfftn(den_local ** beta - n0 ** beta, group),
                   shape, group)
    E = E + TF_COEFF * pqmean((den_local ** alpha - n0 ** alpha) * conv,
                              group) * vol
    E = E + pqmean(_pbe_exchange_density(den_local, gdg)
                   + _pbe_correlation_density(den_local, gdg), group) * vol
    return E


def pvalue_and_potential_wt_pbe(box_vecs, den_local, v_ext_local, shape,
                                group):
    """Distributed fused (E, dE/dn) of :func:`penergy_wt_pbe`'s terms: the
    serial analytic sweep's formulas on pencil transforms.  Returns (global
    E, local potential slab)."""
    from ..models.kinetic_local import TF_COEFF
    from ..models.xc import _pbe_exchange_density, _pbe_correlation_density
    from ..models.potentials import _pw92_eps_and_deriv
    from ..ops.grid import safe_sqrt
    vol = volume(box_vecs)
    kx, ky, kz, k2 = pwavevecs(box_vecs, shape, group)
    den = den_local
    den_ft = prfftn(den, group)
    E = pqmean(den * v_ext_local, group) * vol
    pot = v_ext_local
    nz = k2 != 0
    coul = torch.where(nz, 4.0 * np.pi / torch.where(nz, k2, 1.0), 0.0)
    v_h = pirfftn(coul * den_ft, shape, group)
    E = E + 0.5 * pqmean(den * v_h, group) * vol
    pot = pot + v_h
    E = E + TF_COEFF * pqmean(den ** (5.0 / 3.0), group) * vol
    pot = pot + (5.0 / 3.0) * TF_COEFF * den ** (2.0 / 3.0)
    sqrt_den = safe_sqrt(den)
    lap_s = pirfftn(-k2 * prfftn(sqrt_den, group), shape, group)
    E = E - 0.5 * pqmean(sqrt_den * lap_s, group) * vol
    pos = den > 0
    pot = pot + torch.where(pos, -0.5 * lap_s / torch.where(pos, sqrt_den,
                                                            1.0), 0.0)
    alpha = 5.0 / 6.0
    n0 = (pmean(den, group) * vol).detach() / vol
    d_a = den ** alpha - n0 ** alpha
    conv = pirfftn(_wt_kernel(k2, n0) * prfftn(d_a, group), shape, group)
    E = E + TF_COEFF * pqmean(d_a * conv, group) * vol
    pot = pot + TF_COEFF * 2.0 * alpha * den ** (alpha - 1.0) * conv

    gx, gy, gz = (_igrad(k, den_ft, shape, group) for k in (kx, ky, kz))
    gdg = gx * gx + gy * gy + gz * gz
    E = E + pqmean(_pbe_exchange_density(den, gdg)
                   + _pbe_correlation_density(den, gdg), group) * vol
    epsx = -(3.0 / 4.0) * (3.0 / np.pi) ** (1.0 / 3.0) * den ** (1.0 / 3.0)
    depsx = -(1.0 / 4.0) * (3.0 / np.pi) ** (1.0 / 3.0) * den ** (-2.0 / 3.0)
    c_s = 0.25 * (3.0 * np.pi ** 2) ** (-2.0 / 3.0)
    s2 = c_s * gdg * den ** (-8.0 / 3.0)
    kap, mu_x = 0.804, 0.066725 * np.pi ** 2 / 3.0
    dFx_ds2 = mu_x / (1.0 + mu_x / kap * s2) ** 2
    Fx = 1.0 + kap - kap / (1.0 + mu_x / kap * s2)
    df_dn_x = (Fx * (depsx * den + epsx)
               + dFx_ds2 * (-(8.0 / 3.0) * s2 / den) * epsx * den)
    df_dgn2_x = dFx_ds2 * c_s * den ** (-8.0 / 3.0) * epsx * den
    eps_c, deps_dn_c = _pw92_eps_and_deriv(den)
    beta_c, gamma = 0.066725, float(1.0 - np.log(2.0)) / np.pi ** 2
    A = beta_c / gamma / (torch.exp(-eps_c / gamma) - 1.0 + 1e-30)
    dAdn = 1.0 / beta_c * A * A * torch.exp(-eps_c / gamma) * deps_dn_c
    c_t = (1.0 / 16.0) * (np.pi / 3.0) ** (1.0 / 3.0)
    t2 = c_t * gdg / (den ** (7.0 / 3.0) + 1e-30)
    dt2dn = -7.0 / 3.0 * t2 / den
    dt2dgn2 = c_t / (den ** (7.0 / 3.0) + 1e-30)
    At2 = A * t2
    numer = 1.0 + At2
    denom = 1.0 + At2 + At2 * At2
    H = gamma * torch.log(1.0 + beta_c / gamma * t2 * (numer / denom))
    numer2 = 1.0 + 2.0 * At2
    eH = torch.exp(-H / gamma)
    dHdn = beta_c * eH * (
        (dt2dn * numer2 + dAdn * t2 * t2) / denom
        - t2 * numer / denom ** 2 * (dt2dn * A * numer2 + dAdn * t2 * numer2))
    dH_dgn2 = beta_c * eH * (dt2dgn2 * numer2 / denom
                             - At2 * numer / denom ** 2 * dt2dgn2 * numer2)
    df_dn_c = eps_c + H + den * (deps_dn_c + dHdn)
    w = df_dgn2_x + den * dH_dgn2

    def dk(k, f):
        F = prfftn(f, group)
        return torch.complex(-k * F.imag, k * F.real)

    div = pirfftn(dk(kx, w * gx) + dk(ky, w * gy) + dk(kz, w * gz), shape,
                  group)
    return E, pot + df_dn_x + df_dn_c - 2.0 * div


def _chi_density(chi, box_vecs, N_elec, group):
    """(den_pre, den, s, N_tilde, vol): the chi parameterisation with the
    global normalisation and, in f32, the density floor."""
    vol = volume(box_vecs)
    N_tilde = pwmean(chi * chi, group) * vol
    den_pre = (N_elec / N_tilde) * chi * chi
    if chi.dtype == torch.float32:
        c = 1e-10 * N_elec / vol
        s = N_elec / (N_elec + c * vol)
        return den_pre, (den_pre + c) * s, s, N_tilde, vol
    return den_pre, den_pre, 1.0, N_tilde, vol


def _local_shape(shape, group):
    return (shape[0] // axis_size(group), shape[1], shape[2])


def _chain_chi(chi, pot, den_pre, s, N_tilde, vol, N_elec, shape, group):
    """dE/dchi from dE/dn through the chi parameterisation (the serial
    ``System._chi_value_and_grad_analytic`` chain)."""
    quad_w = vol / float(np.prod(shape))
    mu = pwmean(pot * den_pre, group) * vol / N_elec
    return s * (N_elec / N_tilde) * 2.0 * chi * (pot - mu) * quad_w


def pchi_value_and_grad(chi_local_flat, box_vecs, v_ext_local, N_elec,
                        shape, group):
    """Distributed (E, dE/dchi) of the hand-fused WT + PBE sweep:
    ``chi_local_flat`` is this rank's block of the flat chi (its slab);
    returns (global E, local flat gradient)."""
    chi = chi_local_flat.reshape(_local_shape(shape, group))
    den_pre, den, s, N_tilde, vol = _chi_density(chi, box_vecs, N_elec,
                                                 group)
    E, pot = pvalue_and_potential_wt_pbe(box_vecs, den, v_ext_local, shape,
                                         group)
    g = _chain_chi(chi, pot, den_pre, s, N_tilde, vol, N_elec, shape, group)
    return E, g.reshape(-1)


def pchi_value_and_grad_analytic(terms, chi_local_flat, box_vecs,
                                 v_ext_local, N_elec, shape, group,
                                 aux=None):
    """Distributed (E, dE/dchi) from the GENERIC fused analytic sweep
    (``models.potentials.value_and_potential`` under
    ``ops.grid.pencil_mode``) for any term set it accepts; ``aux`` is the
    term-aux list on this rank's k-pencil (:func:`aux_pencil_specs`)."""
    from ..ops.grid import pencil_mode
    from ..models.potentials import value_and_potential
    chi = chi_local_flat.reshape(_local_shape(shape, group))
    den_pre, den, s, N_tilde, vol = _chi_density(chi, box_vecs, N_elec,
                                                 group)
    with pencil_mode(group):
        E, pot = value_and_potential(terms, box_vecs, den, v_ext_local,
                                     N_elec=N_elec, aux=aux)
    g = _chain_chi(chi, pot, den_pre, s, N_tilde, vol, N_elec, shape, group)
    return E, g.reshape(-1)


def penergy_terms(terms, box_vecs, den_local, v_ext_local, group, aux=None):
    """The GENERIC distributed energy: the serial term bodies under
    ``ops.grid.pencil_mode`` (every transform a pencil FFT, every mean a
    psum), with ``System._density_terms_energy``'s dispatch: IonIon
    excluded, IonElectron on the local v_ext slab, ladder terms on the
    ladder their ``prepare`` cached, and ``aux`` (the term-aux list on this
    rank's k-pencil) where given.  An unprepared ladder term raises."""
    from ..ops.grid import pencil_mode
    E = torch.zeros((), dtype=den_local.dtype, device=den_local.device)
    with pencil_mode(group):
        for i, f in enumerate(terms):
            nm = term_name(f)
            owner = getattr(f, "__self__", f)
            a = aux[i] if aux is not None else None
            if a is not None:
                E = E + owner.apply_aux(a, box_vecs, den_local)
            elif nm == "IonIon":
                continue
            elif nm == "IonElectron":
                E = E + f(box_vecs, den_local, v_ext_local)
            elif hasattr(owner, "forward_static"):
                E = E + owner.forward_static(box_vecs, den_local)
            else:
                E = E + f(box_vecs, den_local)
    return E


def aux_pencil_specs(aux, group):
    """This rank's share of a term-aux list (the JAX package's
    PartitionSpecs and ``device_put`` in one): arrays with >= 3 dimensions
    are half-spectrum shaped (n0, n1, m2[, L]) and keep their axis-1
    k-pencil; small tables stay whole."""
    if aux is None:
        return None
    P, r = axis_size(group), axis_index(group)

    def part(a):
        if torch.is_tensor(a) and a.ndim >= 3:
            step = a.shape[1] // P
            return a.narrow(1, r * step, step)
        return a
    return [None if a is None else {k: part(v) for k, v in a.items()}
            for a in aux]


def pchi_value_and_grad_terms(terms, chi_local_flat, box_vecs, v_ext_local,
                              N_elec, shape, group, aux=None):
    """Distributed (E, dE/dchi) for any term list by autograd of
    :func:`penergy_terms`: each rank differentiates its share E / P
    (``collectives.rank_share``), whose gradient is this rank's block of
    the global gradient (the JAX package divides the gradient by the axis
    size instead)."""
    local_shape = _local_shape(shape, group)
    with torch.enable_grad():
        x = chi_local_flat.detach().requires_grad_(True)
        chi = x.reshape(local_shape)
        _, den, _, _, _ = _chi_density(chi, box_vecs, N_elec, group)
        E = penergy_terms(terms, box_vecs, den, v_ext_local, group, aux=aux)
        (g,) = torch.autograd.grad(rank_share(E, group), x)
    return E.detach(), g


def pencil_tpgd_minimize(mesh, shape, box_vecs, v_ext, N_elec, chi0,
                         M_kernel, lr=1.0, ntol=1e-7, conv_count=3,
                         max_iter=1000, skip_iters=2,
                         f_scale=27.211386245988, method="TPGD", terms=None,
                         aux=None, block=1, analytic=False):
    """A whole distributed density optimization on this rank's slab.

    Every rank calls it with the same WHOLE inputs (chi0 flat or 3-D,
    v_ext, the half-spectrum ``M_kernel`` or None, ``aux``): each keeps its
    axis-0 slab of the fields and its axis-1 k-pencil of the spectra.  The
    solver is ``ops/solvers.py`` in its SPMD mode (``group=``): pencil
    FFTs, psum'd inner products, and the host rule on the same all-reduced
    energy on every rank.  ``method`` "TPGD" (BB2) or "LBFGS" (stopping
    rule every ``block`` iterations).  Gradient: ``terms=None`` the
    hand-fused WT + PBE sweep (:func:`pchi_value_and_grad`); a term list
    with ``analytic=True`` the generic fused sweep, with ``analytic=False``
    autograd of :func:`penergy_terms`.  Returns (state, iterations,
    converged), state.x this rank's flat block (gather with
    ``parallel.mesh.gather_grid``)."""
    from ..ops import solvers
    from .mesh import grid_group
    group, n_dev, idx = grid_group(mesh)
    if shape[0] % n_dev or shape[1] % n_dev:
        raise ValueError(
            f"pencil decomposition needs grid axes 0 and 1 divisible by the "
            f"mesh 'grid' size {n_dev}; got shape {tuple(shape)} (pad the "
            f"grid or choose a compatible mesh).")
    local_shape = _local_shape(shape, group)
    n0 = local_shape[0]
    chi_local = chi0.reshape(shape)[idx * n0:(idx + 1) * n0].reshape(-1)
    v_local = v_ext.reshape(shape)[idx * n0:(idx + 1) * n0]
    aux_local = aux_pencil_specs(aux, group)

    if terms is None:
        def vg(x):
            return pchi_value_and_grad(x, box_vecs, v_local, N_elec, shape,
                                       group)
    elif analytic:
        def vg(x):
            return pchi_value_and_grad_analytic(terms, x, box_vecs, v_local,
                                                N_elec, shape, group,
                                                aux=aux_local)
    else:
        def vg(x):
            return pchi_value_and_grad_terms(terms, x, box_vecs, v_local,
                                             N_elec, shape, group,
                                             aux=aux_local)

    if M_kernel is None:
        aH0 = None
    else:
        step = shape[1] // n_dev
        M_slab = M_kernel.narrow(1, idx * step, step)

        def aH0(q):
            return pconv_dc(M_slab, q.reshape(local_shape), local_shape,
                            group).reshape(q.shape)

    kw = dict(lr=lr, ntol=ntol, conv_count=conv_count, max_iter=max_iter,
              f_scale=f_scale, skip_iters=skip_iters, apply_H0=aH0,
              group=group)
    if method == "LBFGS":
        return solvers.lbfgs_minimize(vg, chi_local, block=block, **kw)
    return solvers.tpgd_minimize(vg, chi_local, **kw)
