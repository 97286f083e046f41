"""Preconditioned two-point gradient descent (TPGD) for density optimization.

PyTorch port of ``professad_tpu/ops/solvers.py::tpgd_minimize`` /
``tpgd_iteration`` / ``TPGDState``: BB2 steps ``x <- x - H M g`` in the
M-inner product, stagnation-triggered damping and best-iterate tracking,
with the same stopping rule (``|dE| * f_scale < ntol`` for ``conv_count``
consecutive iterations after ``skip_iters``).

Host loop decision: the JAX package runs the whole optimization as one
``lax.while_loop`` program.  Here the loop is Python, and each iteration
reads ONE device scalar to the host — the new energy, ``f.item()`` — which
is all the stopping rule, the stagnation damping and the best-iterate
choice need; they then run in host float64 arithmetic, exactly as the
JAX package's f64 scalar logic.  Everything else in the iteration (the BB
step size, the update, the energy and gradient) stays on the device with
no further synchronisation.  Capturing the iteration in a CUDA graph is
later work.
"""

from typing import NamedTuple

import torch

__all__ = ["TPGDState", "tpgd_iteration", "tpgd_minimize"]

_STAG_K = 6  # iterations without a new best energy before the step halves


class TPGDState(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor         # 0-d energy (f64 for f32 and f64 fields)
    g: torch.Tensor
    g_prev: torch.Tensor
    Mg_prev: torch.Tensor   # preconditioned previous gradient
    s_prev: torch.Tensor    # the last move, fl(x_new) - fl(x_old)
    n_iter: int


def tpgd_iteration(value_and_grad, st, lr, apply_H0=None, scale=1.0):
    """One (preconditioned) TPGD update.  ``scale`` damps the BB step.

    The preconditioner is applied ONCE per iteration: M is linear, so
    M y = M g - M g_prev with the previous application carried in the
    state.  ``s_prev`` stores the exact difference fl(x_new) - fl(x_old):
    near the fixed point it hits exact zero, which is what lets the f32
    iteration stop cleanly."""
    M = (lambda v: v) if apply_H0 is None else apply_H0
    y = st.g - st.g_prev
    Mg = M(st.g)
    My = Mg - st.Mg_prev
    d = -Mg
    if st.n_iter == 0:
        # first step: gradient-magnitude-calibrated
        t = torch.clamp(1.0 / torch.sum(torch.abs(d)), max=1.0) * lr
    else:
        ys = torch.sum(y * st.s_prev)
        yMy = torch.sum(y * My)
        # non-positive curvature falls back to an lr-scaled step
        H = torch.where(ys <= 0.0, lr, ys / torch.where(yMy != 0, yMy, 1.0))
        t = H * scale
    x_new = st.x + t * d
    s_new = x_new - st.x
    f_new, g_new = value_and_grad(x_new)
    return TPGDState(x=x_new, f=f_new, g=g_new.reshape(st.x.shape),
                     g_prev=st.g, Mg_prev=Mg, s_prev=s_new,
                     n_iter=st.n_iter + 1)


def tpgd_minimize(value_and_grad, x0, lr=0.1, ntol=1e-7, conv_count=3,
                  max_iter=1000, f_scale=1.0, skip_iters=2, apply_H0=None):
    """Preconditioned TPGD to convergence.  Returns (state, n_iters,
    converged).

    Stagnation damping: after ``_STAG_K`` consecutive iterations without a
    new best energy by more than the dtype's resolution (8 eps |f_best|),
    the step scale halves, forcing the iterate onto its floating-point fixed
    point so the dE rule fires.  The returned state is the lowest-energy
    iterate seen (its ``g`` and BB memory belong to the last one): the BB
    trajectory is non-monotone, and damping may freeze it just above a
    visited minimum."""
    f0, g0 = value_and_grad(x0)
    g0 = g0.reshape(x0.shape)
    eps = torch.finfo(x0.dtype).eps
    zeros = torch.zeros_like(g0)
    st = TPGDState(x=x0, f=f0, g=g0, g_prev=g0, Mg_prev=zeros,
                   s_prev=zeros, n_iter=0)
    f_prev = f0.item()
    f_best, f_best_t, x_best = f_prev, f0, x0
    cnt = it = stag = 0
    damp = 1.0
    while cnt < conv_count and it < max_iter:
        st = tpgd_iteration(value_and_grad, st, lr, apply_H0=apply_H0,
                            scale=damp)
        f_new = st.f.item()
        tol_stag = 8.0 * eps * max(abs(f_best), 1.0)
        improved = f_best - f_new > tol_stag
        if f_new < f_best:
            f_best, f_best_t, x_best = f_new, st.f, st.x
        stag = 0 if improved else stag + 1
        if stag >= _STAG_K:
            damp *= 0.5
            stag = 0
        hit = it + 1 > skip_iters and abs(f_new - f_prev) * f_scale < ntol
        cnt = cnt + 1 if hit else 0
        it += 1
        f_prev = f_new
    if f_best < f_prev:
        st = st._replace(x=x_best, f=f_best_t)
    return st, it, cnt >= conv_count
