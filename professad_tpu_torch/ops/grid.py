"""Reciprocal-space grid math: wavevectors, FFT derivatives, compensated means.

PyTorch port of ``professad_tpu/ops/grid.py`` (all but the TPU-only
transforms).  Conventions kept from the JAX package:

* ``wavevecs`` is a differentiable function of ``box_vecs``; the integer
  frequency tables are built on the box's device and dtype each call.
* Masked singular expressions use the double-``where`` idiom, so gradients
  stay NaN-free under ``torch.autograd`` and ``torch.func``.
* Everything is dtype-polymorphic: float64 is the correctness tier, float32
  the fast tier.  f32 3-D transforms are DC-split, and ``qmean`` / ``wmean``
  give f64-accurate means of f32 fields.
* No in-place writes on values that may be traced: the DC fix-ups use the
  out-of-place ``torch.index_put``, so ``torch.func.jvp`` over
  ``torch.func.grad`` (the preconditioner HVP) goes through.
* ``pencil_mode(group)`` redirects ``rfftn`` / ``irfftn`` / ``wavevecs`` /
  ``qmean`` / ``wmean`` / ``spectral_convolution`` to the pencil-decomposed
  forms of ``parallel.pfft`` on a ``torch.distributed`` group, so the
  serial term bodies evaluate on axis-0 slabs of a distributed grid;
  ``pencil_mode(None)`` leaves them serial.
* ``_chi_map`` / ``_chi_chain`` are the one chi parameterisation of the
  density solvers (its float32 floor included), serial and on the pencils.
"""

import numpy as np
import torch

__all__ = [
    "inv3x3", "volume", "rfft_shape", "wavevecs", "wavenumbers", "imul",
    "expi", "qmean", "wmean", "safe_sqrt",
    "rfftn", "irfftn", "spectral_convolution", "spectral_resample", "grad_i",
    "laplacian", "grad_dot_grad", "reduced_gradient",
    "reduced_gradient_squared", "reduced_laplacian", "pencil_mode",
]


def _det3(m):
    a, b, c = m[0, 0], m[0, 1], m[0, 2]
    d, e, f = m[1, 0], m[1, 1], m[1, 2]
    g, h, i = m[2, 0], m[2, 1], m[2, 2]
    return a * (e * i - f * h) + b * (f * g - d * i) + c * (d * h - e * g)


def inv3x3(m):
    """Analytic 3x3 inverse via the adjugate (differentiable, any dtype).

    Singular cells are rejected where the cell is set (``System``), on the
    host, so this stays free of device-to-host synchronisation."""
    a, b, c = m[0, 0], m[0, 1], m[0, 2]
    d, e, f = m[1, 0], m[1, 1], m[1, 2]
    g, h, i = m[2, 0], m[2, 1], m[2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    adj = torch.stack([torch.stack([A, B, C]),
                       torch.stack([D, E, F]),
                       torch.stack([G, H, I])])
    return adj / det


def rfft_shape(shape):
    """Shape of the half-spectrum rfftn output for a real grid of ``shape``."""
    return (*shape[:-1], shape[-1] // 2 + 1)


def volume(box_vecs):
    """Cell volume |det h| (rows of ``box_vecs`` are lattice vectors)."""
    return torch.abs(_det3(box_vecs))


def _freq_indices(shape, dtype, device):
    """Integer FFT frequency tables in rfftn layout, as broadcastable
    tensors.  The Nyquist index of the two full axes is +n/2 (not -n/2),
    as in the JAX package."""
    n0, n1, n2 = shape

    def full(n):
        j = torch.arange(n, dtype=dtype, device=device)
        return torch.where(j <= n // 2, j, j - n)

    j2 = torch.arange(n2 // 2 + 1, dtype=dtype, device=device)
    return full(n0).reshape(-1, 1, 1), full(n1).reshape(1, -1, 1), \
        j2.reshape(1, 1, -1)


def wavevecs(box_vecs, shape):
    """Wavevectors kx, ky, kz, k2 on the rfftn half-spectrum grid;
    differentiable with respect to ``box_vecs``.  Under ``pencil_mode``
    ``shape`` is the local slab's and the result this rank's k-pencil of
    the global grid."""
    if _PENCIL is not None:
        from ..parallel import pfft
        from ..parallel.collectives import axis_size
        gshape = (shape[0] * axis_size(_PENCIL), shape[1], shape[2])
        return pfft.pwavevecs(box_vecs, gshape, _PENCIL)
    b = 2.0 * np.pi * inv3x3(box_vecs.T)  # reciprocal lattice rows
    nA, nB, nC = _freq_indices(tuple(shape), box_vecs.dtype, box_vecs.device)
    kx = nA * b[0, 0] + nB * b[1, 0] + nC * b[2, 0]
    ky = nA * b[0, 1] + nB * b[1, 1] + nC * b[2, 1]
    kz = nA * b[0, 2] + nB * b[1, 2] + nC * b[2, 2]
    k2 = kx * kx + ky * ky + kz * kz
    return kx, ky, kz, k2


def wavenumbers(box_vecs, shape):
    """|k| on the half-spectrum grid, zero-safe at the origin."""
    return safe_sqrt(wavevecs(box_vecs, shape)[3])


def imul(k, ft):
    """(i k) * ft for real k and complex ft, in real arithmetic."""
    return torch.complex(-k * ft.imag, k * ft.real)


def expi(theta):
    """e^{i theta} for real theta: complex64 for float32, complex128 for
    float64."""
    return torch.complex(torch.cos(theta), torch.sin(theta))


def _colsum_mean64(x):
    """f64 mean of an f32 field: f32 sums over 512 columns, combined in
    f64.  Plain differentiable ops, so the backward is an f32 broadcast and
    forward-mode AD (the preconditioner HVP) composes."""
    n = x.numel()
    cols = 512
    xf = x.reshape(-1)
    pad = (-n) % cols
    if pad:
        xf = torch.cat([xf, xf.new_zeros(pad)])
    partial = xf.reshape(-1, cols).sum(0)
    return partial.to(torch.float64).sum() / n


def qmean(x):
    """Quadrature mean for energy terms: f64-accurate value, f32 backward.

    For f32 input this returns an f64 scalar (energies and dE stay
    resolvable at the 1e-7 eV stopping rule); f64 input takes a plain mean.
    Only for terminal scalars: means that feed array arithmetic use
    :func:`wmean`, or they would upcast the graph."""
    if _PENCIL is not None:
        from ..parallel import pfft
        return pfft.pqmean(x, _PENCIL)
    if x.dtype != torch.float32:
        return torch.mean(x)
    return _colsum_mean64(x)


def wmean(x):
    """Working-dtype accurate mean, for means that feed array arithmetic
    (N_tilde normalisation, chemical potential).  Same column-sum + f64
    combine as :func:`qmean`, cast back to the input dtype."""
    if _PENCIL is not None:
        from ..parallel import pfft
        return pfft.pwmean(x, _PENCIL)
    if x.dtype != torch.float32:
        return torch.mean(x)
    return _colsum_mean64(x).to(x.dtype)


def safe_sqrt(x):
    """NaN-free-gradient sqrt: 0 where x <= 0 (double-where idiom)."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


# ------------------- the chi parameterisation of the solvers ----------------

def _chi_map(chi, vol, N_elec):
    """The density of the solvers' variable, n = N_e chi^2 / int chi^2:
    (den_pre, den, s, N_tilde).  ``den_pre`` is the plain map; ``den``
    floors it, in float32, at 1e-10 of the mean N_e / vol, renormalised by
    ``s`` so that negative powers stay finite (float64: den is den_pre and
    s is 1).  The mean is :func:`wmean`: under ``pencil_mode`` chi is this
    rank's slab and the normalisation global."""
    N_tilde = wmean(chi * chi) * vol
    den_pre = (N_elec / N_tilde) * chi * chi
    if chi.dtype != torch.float32:
        return den_pre, den_pre, 1.0, N_tilde
    c = 1e-10 * N_elec / vol
    s = N_elec / (N_elec + c * vol)
    return den_pre, (den_pre + c) * s, s, N_tilde


def _chi_chain(chi, pot, den_pre, s, N_tilde, vol, N_elec):
    """dE/dchi from pot = dE/dn at the density of :func:`_chi_map`:
    s (N_e / N_tilde) 2 chi (pot - mu) w, with mu = mean(pot den_pre) vol /
    N_e and w = vol / (points of the whole grid)."""
    n = chi.numel()
    if _PENCIL is not None:
        from ..parallel.collectives import axis_size
        n *= axis_size(_PENCIL)
    quad_w = vol / n
    mu = wmean(pot * den_pre) * vol / N_elec
    return s * (N_elec / N_tilde) * 2.0 * chi * (pot - mu) * quad_w


def _origin(t):
    i0 = torch.zeros(1, dtype=torch.long, device=t.device)
    return (i0, i0, i0)


def rfftn(x):
    """3-D real FFT.  f32 3-D fields are DC-split: the mean is subtracted
    before the transform and the k=0 coefficient set from it exactly, so the
    f32 FFT cannot leak the DC amplitude into the lowest modes and uniform
    fields transform exactly."""
    if _PENCIL is not None:
        from ..parallel import pfft
        return pfft.prfftn_dc(_pencil_3d(x), _PENCIL)
    if x.dtype == torch.float32 and x.ndim == 3:
        xm = torch.mean(x)
        h = torch.fft.rfftn(x - xm)
        dc = (xm * x.numel()).to(h.dtype).reshape(1)
        return torch.index_put(h, _origin(h), dc, accumulate=True)
    return torch.fft.rfftn(x)


def irfftn(X, shape):
    """Inverse of :func:`rfftn` (1/N-normalised, real output).  f32 3-D
    spectra carry the k=0 coefficient around the transform as an exact
    uniform shift."""
    shape = tuple(shape)
    if _PENCIL is not None:
        from ..parallel import pfft
        return pfft.pirfftn_dc(_pencil_3d(X), shape, _PENCIL)
    if X.dtype == torch.complex64 and X.ndim == 3:
        dc = X[0, 0, 0].real
        Xz = torch.index_put(X, _origin(X), X.new_zeros(1))
        y = torch.fft.irfftn(Xz, s=shape)
        return y + dc / (shape[0] * shape[1] * shape[2])
    return torch.fft.irfftn(X, s=shape)


def spectral_convolution(kern, field, shape):
    """irfftn(kern * rfftn(field)) for a REAL half-spectrum kernel: the
    dedicated-convolution primitive (WT kernel, vW Laplacian,
    preconditioner).  3-D fields go through ``ops.spectral_conv``, which
    launches the CUDA kernel for CUDA tensors and runs its ``torch.fft``
    reference for CPU tensors.  Under ``pencil_mode`` the field is a slab
    of a distributed grid, which that kernel would take for a whole
    periodic grid: the pencil transforms are composed instead
    (``pfft.pconv_dc``, with the kernel's f32 DC split), as the JAX package
    turns its Pallas convolution off there."""
    if field.ndim == 3 and _PENCIL is None:
        from .spectral_conv import spectral_conv
        return spectral_conv(field, kern)
    if field.ndim == 3:
        from ..parallel import pfft
        return pfft.pconv_dc(kern, field, shape, _PENCIL)
    return irfftn(kern * rfftn(field), shape)


_PENCIL = None   # the process group of the active pencil_mode


def _pencil_3d(x):
    if x.ndim != 3:
        raise NotImplementedError(
            "pencil mode transforms 3-D fields only; the ladder terms' 4-D "
            "transforms go through ops.fieldconv's pencil forms")
    return x


class pencil_mode:
    """Context under which the core spectral primitives run pencil-
    decomposed on the "grid" group of a ``torch.distributed`` mesh
    (``parallel.pfft``): ``rfftn`` / ``irfftn`` become pencil transforms
    (one all_to_all each), ``wavevecs`` gives this rank's k-pencil,
    ``qmean`` / ``wmean`` reduce over the group and
    ``spectral_convolution`` composes the pencil transforms.  The serial
    term bodies of ``models/`` then evaluate distributed on axis-0 slabs,
    callers passing local shapes where the serial code passes whole ones;
    the ladder terms' 4-D transforms ride one batched all_to_all
    (``ops.fieldconv``).  ``group``: a process group, or a ``DeviceMesh``
    with a "grid" axis.  Every rank of the group must run the same code
    under it."""

    def __init__(self, group):
        if hasattr(group, "mesh_dim_names"):
            group = group["grid"].get_group()
        self.group = group

    def __enter__(self):
        global _PENCIL
        self._prev = _PENCIL
        _PENCIL = self.group
        return self

    def __exit__(self, *exc):
        global _PENCIL
        _PENCIL = self._prev
        return False


def spectral_resample(field, new_shape):
    """Band-limited (Fourier) resampling of a periodic real field onto
    another grid over the same cell: every plane-wave component common to
    both grids keeps its coefficient.  The source's Nyquist planes are
    dropped on every axis whose size changes (a self-conjugate mode cannot
    be split between the +/- frequencies of a finer grid); an unchanged
    axis transfers everything.  Works up (zero-padding) and down
    (truncation); the mean is kept exactly."""
    old_shape = tuple(field.shape)
    new_shape = tuple(int(n) for n in new_shape)
    if len(old_shape) != 3 or len(new_shape) != 3:
        raise ValueError("spectral_resample expects 3-D fields")
    if old_shape == new_shape:
        return field
    F = rfftn(field)
    m_new = new_shape[2] // 2 + 1
    G = torch.zeros((new_shape[0], new_shape[1], m_new), dtype=F.dtype,
                    device=F.device)

    def pairs(n_old, n_new):
        """(old slice, new slice) pairs carrying every transferred
        frequency of one full axis."""
        if n_old == n_new:
            return [(slice(0, n_old), slice(0, n_old))]
        h = (min(n_old, n_new) - 1) // 2  # highest |frequency| kept
        out = [(slice(0, h + 1), slice(0, h + 1))]
        if h:
            out.append((slice(n_old - h, n_old), slice(n_new - h, n_new)))
        return out

    if old_shape[2] == new_shape[2]:
        cols = slice(0, m_new)
    else:
        cols = slice(0, (min(old_shape[2], new_shape[2]) - 1) // 2 + 1)
    for r_old, r_new in pairs(old_shape[0], new_shape[0]):
        for c_old, c_new in pairs(old_shape[1], new_shape[1]):
            G[r_new, c_new, cols] = F[r_old, c_old, cols]
    scale = float(np.prod(new_shape)) / float(np.prod(old_shape))
    return irfftn(G * scale, new_shape)


def grad_i(ki, f):
    """Spectral partial derivative df/dr_i."""
    return irfftn(imul(ki, rfftn(f)), f.shape)


def grad_dot_grad(kx, ky, kz, f):
    """|grad f|^2 via three spectral derivatives."""
    f_ft = rfftn(f)
    gx = irfftn(imul(kx, f_ft), f.shape)
    gy = irfftn(imul(ky, f_ft), f.shape)
    gz = irfftn(imul(kz, f_ft), f.shape)
    return gx * gx + gy * gy + gz * gz


def laplacian(k2, f):
    """Spectral Laplacian."""
    return irfftn(-k2 * rfftn(f), f.shape)


# ---------------------------- density descriptors ---------------------------

def reduced_gradient(kx, ky, kz, den):
    """s = |grad n| / (2 (3 pi^2)^{1/3} n^{4/3})."""
    abs_grad = safe_sqrt(grad_dot_grad(kx, ky, kz, den))
    return (0.5 * (3.0 * np.pi**2) ** (-1.0 / 3.0) * abs_grad
            * den ** (-4.0 / 3.0))


def reduced_gradient_squared(kx, ky, kz, den):
    """s^2 = |grad n|^2 / (4 (3 pi^2)^{2/3} n^{8/3})."""
    return (0.25 * (3.0 * np.pi**2) ** (-2.0 / 3.0)
            * grad_dot_grad(kx, ky, kz, den) * den ** (-8.0 / 3.0))


def reduced_laplacian(k2, den):
    """q = lap n / (4 (3 pi^2)^{2/3} n^{5/3})."""
    return (0.25 * (3.0 * np.pi**2) ** (-2.0 / 3.0)
            * laplacian(k2, den) * den ** (-5.0 / 3.0))
