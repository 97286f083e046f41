"""Differentiable cubic Hermite interpolation (1-D table -> N-D queries).

PyTorch port of ``professad_tpu/ops/interp.py``: ``interpolate`` (a 1-D
table at N-D queries) and ``interpolate_kernel`` (a stack of slabs along a
ladder axis at a spatially varying ladder coordinate), with the same
Catmull-Rom tangents.  The four Hermite basis polynomials are evaluated
directly; gathers are plain tensor indexing.
"""

import torch

__all__ = ["interpolate", "interpolate_kernel"]


def _bracket(x, xs):
    """Index of the knot interval containing each query.

    Tables (recpot grids, kernel tables, xi ladders) are constants, so the
    uniform-spacing test reads them (one device-to-host copy); a uniform
    table brackets with one multiply+truncate, others with
    ``searchsorted``."""
    n = x.shape[0]
    d = torch.diff(x.detach())
    if d.numel() and bool(torch.allclose(d, d[:1].expand_as(d), rtol=1e-9,
                                         atol=0.0)):
        step = float(d[0])
        idx = torch.floor((xs - float(x[0])) / step).to(torch.long)
        return torch.clamp(idx, 0, n - 2)
    idx = torch.searchsorted(x[1:].contiguous(), xs.contiguous(), side="left")
    return torch.clamp(idx, 0, n - 2)


def _hermite_weights(t):
    """Hermite basis h00, h10, h01, h11 at parameter t in [0, 1]."""
    t2 = t * t
    t3 = t2 * t
    h00 = 1.0 - 3.0 * t2 + 2.0 * t3
    h10 = t - 2.0 * t2 + t3
    h01 = 3.0 * t2 - 2.0 * t3
    h11 = t3 - t2
    return h00, h10, h01, h11


def _tangents(x, y, axis=-1):
    """Catmull-Rom-style tangents: secant slopes, averaged at interior
    knots."""
    m = torch.diff(y, dim=axis) / torch.diff(x, dim=axis)
    n = m.shape[axis]
    first = m.narrow(axis, 0, 1)
    last = m.narrow(axis, n - 1, 1)
    inner = 0.5 * (m.narrow(axis, 1, n - 1) + m.narrow(axis, 0, n - 1))
    return torch.cat([first, inner, last], dim=axis)


def interpolate(x, y, xs):
    """Cubic Hermite spline evaluation of the table y(x) at query points xs
    (xs within [x[0], x[-1]]; callers clamp)."""
    m = _tangents(x, y)
    idx = _bracket(x, xs)
    x0 = x[idx]
    dx = x[idx + 1] - x0
    t = (xs - x0) / dx
    h00, h10, h01, h11 = _hermite_weights(t)
    return (h00 * y[idx] + h10 * m[idx] * dx + h01 * y[idx + 1]
            + h11 * m[idx + 1] * dx)


def interpolate_kernel(xi_sparse, f, xis):
    """Interpolate the slabs f(x, y, z, xi_i), (n1, n2, n3, n_xi), along the
    ladder xi_sparse (increasing) onto the field xi(x, y, z); returns
    (n1, n2, n3).  Ladders of up to 32 rungs contract densely with one-hot
    weights, longer ones gather, as in the JAX package."""
    m = _tangents(xi_sparse, f)
    idx = _bracket(xi_sparse, xis)
    x0 = xi_sparse[idx]
    dx = xi_sparse[idx + 1] - x0
    t = (xis - x0) / dx
    h00, h10, h01, h11 = _hermite_weights(t)

    if f.shape[-1] <= 32:
        jj = torch.arange(f.shape[-1], device=f.device)
        e = idx[..., None]
        on0 = (jj == e).to(f.dtype)
        on1 = (jj == e + 1).to(f.dtype)
        Wf = h00[..., None] * on0 + h01[..., None] * on1
        Wm = (h10[..., None] * on0 + h11[..., None] * on1) * dx[..., None]
        return torch.sum(Wf * f + Wm * m, dim=-1)

    idx_e = idx[..., None]
    f0 = torch.gather(f, -1, idx_e)[..., 0]
    f1 = torch.gather(f, -1, idx_e + 1)[..., 0]
    m0 = torch.gather(m, -1, idx_e)[..., 0]
    m1 = torch.gather(m, -1, idx_e + 1)[..., 0]
    return h00 * f0 + h10 * m0 * dx + h01 * f1 + h11 * m1 * dx
