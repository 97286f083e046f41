"""Differentiable cubic Hermite interpolation (1-D table -> N-D queries).

PyTorch port of ``professad_tpu/ops/interp.py`` (``interpolate`` and its
helpers).  The four Hermite basis polynomials are evaluated directly;
gathers are plain tensor indexing.
"""

import numpy as np
import torch

__all__ = ["interpolate"]


def _bracket(x, xs):
    """Index of the knot interval containing each query.

    Tables (recpot grids) are constants, so the uniform-spacing test runs
    once on the host; a uniform table brackets with one multiply+truncate,
    others with ``searchsorted``."""
    xv = x.detach().cpu().numpy()
    d = np.diff(xv)
    n = x.shape[0]
    if d.size and np.allclose(d, d[0], rtol=1e-9, atol=0.0):
        step = float(d[0])
        idx = torch.floor((xs - float(xv[0])) / step).to(torch.long)
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
