"""Field-dependent convolution via the xi-ladder spline method.

PyTorch port of ``professad_tpu/ops/fieldconv.py``.  Computes
K(r) = int d3r' f(|r - r'|, xi(r)) g(r') in quasi-linear time: the
convolution for a sparse ladder of constant-xi kernels is one batched 4-D
transform over the grid axes (``torch.fft`` with ``dim=(0, 1, 2)``; the
ladder axis trails), then a cubic-Hermite interpolation along the ladder
axis at the spatially varying xi(r).

The ladder is sized from the min / max of xi(r) on the host
(``xi_ladder``); callers that need a fixed ladder (the optimizer paths,
``prepare``) pass it as ``xi_sparse``.  f32 transforms are DC-split per
slab.  Under ``ops.grid.pencil_mode`` the 4-D transforms are the pencil
transforms of ``parallel.pfft``: the trailing ladder axis rides one batched
all_to_all, and the DC split is taken per slab there too.
"""

import numpy as np
import torch

from .grid import _freq_indices
from .interp import interpolate_kernel

__all__ = ["xi_ladder", "field_dependent_convolution",
           "field_dependent_convolution_naive", "ladder_convolution",
           "ladder_adjoint"]

_GRID = (0, 1, 2)


def _dc_index(t):
    i0 = torch.zeros(1, dtype=torch.long, device=t.device)
    return (i0, i0, i0)


def _rfftn3(x):
    """Real FFT over the grid axes (0, 1, 2) of a field or a stack of slabs
    (trailing ladder axis).  f32 is DC-split per slab: each slab's mean is
    subtracted before the transform and its k = 0 coefficient set from it
    exactly."""
    if x.dtype == torch.float32:
        n_grid = x.shape[0] * x.shape[1] * x.shape[2]
        xm = torch.mean(x, dim=_GRID, keepdim=True)
        h = torch.fft.rfftn(x - xm, dim=_GRID)
        dc = (xm[0, 0, 0] * n_grid).to(h.dtype).unsqueeze(0)
        return torch.index_put(h, _dc_index(h), dc, accumulate=True)
    return torch.fft.rfftn(x, dim=_GRID)


def _irfftn3(X, shape):
    """Inverse of :func:`_rfftn3` (per-slab DC carried exactly)."""
    shape = tuple(shape)
    if X.dtype == torch.complex64:
        n_grid = shape[0] * shape[1] * shape[2]
        dc = X[0, 0, 0].real
        Xz = torch.index_put(X, _dc_index(X), torch.zeros_like(X[:1, 0, 0]))
        y = torch.fft.irfftn(Xz, s=shape, dim=_GRID)
        return y + dc / n_grid
    return torch.fft.irfftn(X, s=shape, dim=_GRID)


def _pencil():
    from . import grid
    return grid._PENCIL


def _conv(W, g, shape):
    """irfftn(W * rfftn(g)[..., None]) over the grid axes, serial or (under
    ``pencil_mode``) on this rank's slab and k-pencil."""
    group = _pencil()
    if group is not None:
        from ..parallel import pfft
        return pfft.pirfftn_dc(W * pfft.prfftn_dc(g, group)[..., None],
                               g.shape, group)
    return _irfftn3(W * _rfftn3(g)[..., None], shape)


def ladder_convolution(W, g, shape):
    """irfftn(W * rfftn(g)[..., None]) over the grid axes: the field-
    dependent convolution with a precomputed (m1, m2, m3, L) slab stack W
    (a term's hoisted kernel slabs; under ``pencil_mode`` its k-pencil)."""
    return _conv(W, g, shape)


def ladder_adjoint(W, B, shape):
    """irfftn(sum_j W_j * rfftn(B_j)) over the grid axes: the adjoint of
    :func:`ladder_convolution` for real |k|-symmetric slabs (one batched
    forward transform of the weighted fields B (n1, n2, n3, L), the ladder
    contraction in k-space, one 3-D inverse)."""
    group = _pencil()
    if group is not None:
        from ..parallel import pfft
        return pfft.pirfftn_dc(torch.sum(W * pfft.prfftn_dc(B, group),
                                         dim=-1), B.shape[:3], group)
    return _irfftn3(torch.sum(W * _rfftn3(B), dim=-1), shape)


def xi_ladder(xi_min, xi_max, kappa, mode="arithmetic"):
    """Sparse xi ladder covering [xi_min, xi_max] with a margin of three
    rungs on each side (host-side numpy, float64)."""
    xi_min = float(xi_min)
    xi_max = float(xi_max)
    if mode == "arithmetic":
        lower = (np.floor(xi_min / kappa) - 3) * kappa
        upper = (np.ceil(xi_max / kappa) + 3) * kappa
        xi_sparse = np.arange(lower, upper, kappa, dtype=np.float64)
        xi_sparse[xi_sparse == 0] = xi_min
    elif mode == "geometric":
        if not kappa > 1:
            raise ValueError("kappa > 1 required for geometric-progression "
                             "ladder")
        lower = kappa ** (-(np.ceil(-np.log(xi_min) / np.log(kappa)) + 3))
        N = int(np.ceil(np.log((xi_max + 1) / lower) / np.log(kappa)) + 3)
        xi_sparse = lower * kappa ** np.arange(N, dtype=np.float64)
    else:
        raise ValueError("mode must be 'arithmetic' or 'geometric'")
    return xi_sparse


def field_dependent_convolution(k, f_tilde, g, xis, kappa=None,
                                mode="arithmetic", xi_sparse=None):
    """K(r) = int d3r' f(|r-r'|, xi(r)) g(r') by the spline method.

    ``k``: |k| (or k^2, per the kernel's convention) on the half-spectrum
    grid; ``f_tilde(k, xi_sparse)`` -> (m1, m2, m3, n_xi), the kernel's
    transform at each ladder value; ``g`` and ``xis`` (n1, n2, n3).  The
    ladder is ``xi_sparse`` when given, else sized from xis with
    ``kappa`` and ``mode``; under ``pencil_mode`` (k, g and xis local) it
    must be given, since every rank has to take the same ladder."""
    if xi_sparse is None:
        if _pencil() is not None:
            raise NotImplementedError(
                "field_dependent_convolution under ops.grid.pencil_mode "
                "needs a precomputed static xi ladder (call the term's "
                "prepare() first)")
        xi_sparse = xi_ladder(torch.min(xis).detach(),
                              torch.max(xis).detach(), kappa, mode)
    xi_sparse = torch.as_tensor(xi_sparse, dtype=g.dtype, device=g.device)
    conv = _conv(f_tilde(k, xi_sparse), g, g.shape)
    return interpolate_kernel(xi_sparse, conv, xis)


def field_dependent_convolution_naive(k, f_tilde, g, xis, batch=512):
    """Exact per-point field-dependent convolution (no ladder): for every
    grid point r, the r-th entry of the convolution of g with the
    constant-xi kernel at xi(r), evaluated as one row of the inverse
    transform,

        u(r) = (1/N) sum_k c_k f~(k, xi(r)) Re[g~(k) e^{i k.r}]

    over the stored half-spectrum (c_k = 1 on the t = 0 and, for even n3,
    Nyquist planes, 2 elsewhere), in blocks of ``batch`` points.  O(N^2)
    work: the cross-check oracle of the spline method, for coarse grids.
    ``f_tilde`` must be real and elementwise in its first argument.  It
    has no pencil form."""
    if _pencil() is not None:
        raise NotImplementedError(
            "field_dependent_convolution_naive has no pencil (distributed) "
            "form; it cannot run under ops.grid.pencil_mode")
    shape = tuple(g.shape)
    n0, n1, n2 = shape
    m2 = n2 // 2 + 1
    N = n0 * n1 * n2
    dt, dev = g.dtype, g.device
    g_tilde = torch.fft.rfftn(g)
    gr = g_tilde.real.reshape(-1).to(dt)
    gi = g_tilde.imag.reshape(-1).to(dt)
    j0, j1, j2 = _freq_indices(shape, dt, dev)
    half = (n0, n1, m2)
    w = torch.full((m2,), 2.0, dtype=dt, device=dev)
    w[0] = 1.0
    if n2 % 2 == 0:
        w[-1] = 1.0
    W3 = w.expand(half).reshape(-1)
    # phase angles depend only on integer indices (2 pi j.i / n)
    A0 = 2.0 * np.pi * j0.expand(half).reshape(-1) / n0
    A1 = 2.0 * np.pi * j1.expand(half).reshape(-1) / n1
    A2 = 2.0 * np.pi * j2.expand(half).reshape(-1) / n2
    kflat = k.reshape(-1)
    xis_flat = xis.reshape(-1)

    out = []
    for start in range(0, N, batch):
        ib = torch.arange(start, min(start + batch, N), device=dev)
        i0 = (ib // (n1 * n2)).to(dt)
        i1 = ((ib // n2) % n1).to(dt)
        i2 = (ib % n2).to(dt)
        theta = A0[:, None] * i0 + A1[:, None] * i1 + A2[:, None] * i2
        Wk = f_tilde(kflat, xis_flat[ib])        # (H, B)
        # inverse-transform row: Re[g~ e^{+i theta}] = gr cos - gi sin
        re = torch.cos(theta) * gr[:, None] - torch.sin(theta) * gi[:, None]
        out.append(torch.sum(W3[:, None] * Wk * re, dim=0) / N)
    return torch.cat(out).reshape(shape)
