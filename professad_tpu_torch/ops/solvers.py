"""Density-optimization solvers: L-BFGS and two-point gradient descent.

PyTorch port of ``professad_tpu/ops/solvers.py``:

* ``LBFGSState`` / ``lbfgs_init`` / ``lbfgs_iterations`` /
  ``lbfgs_minimize``: L-BFGS (history 8) with a fixed step ``lr`` along the
  two-loop direction, the first step scaled to ``min(1, 1/|g|_1) lr``, the
  curvature filter ``y.s > 1e-10 |s|^2`` on the memory update and an
  optional SPD preconditioner ``M`` as the initial inverse Hessian.  The
  ring buffers and the curvature filter stay on the device (``torch.where``
  on 0-d tensors), so a block of iterations never synchronises.
* ``TPGDState`` / ``tpgd_iteration`` / ``tpgd_minimize``: BB2 steps
  ``x <- x - H M g`` in the M-inner product, stagnation-triggered damping
  (``stag_k``) and, unless ``track_best=False``, best-iterate tracking.
* ``tpgd_init`` / ``tpgd_step``: the unpreconditioned BB1 step of the host
  loop.
* ``cg``: preconditioned conjugate gradients with the stopping rule of
  ``jax.scipy.sparse.linalg.cg`` (the Hessian solves of ``ops/implicit.py``).
* ``tpgd_minimize_lanes`` / ``lbfgs_minimize_lanes``: B independent
  problems (lanes) at once, the JAX package's ``tpgd_minimize`` /
  ``lbfgs_minimize`` under ``jax.vmap`` (the batched EOS scan).  The device
  step is ``torch.func.vmap`` of ``tpgd_iteration`` / ``lbfgs_iterations``;
  a lane that has stopped is frozen by a ``torch.where`` on the carried
  state, as the batching rule of ``lax.while_loop`` selects.

Host loop decision: the JAX package runs a whole optimization as one
``lax.while_loop`` program.  Here the loops are Python, and they read ONE
device scalar to the host per check of the stopping rule — per iteration
for TPGD (the new energy, ``f.item()``, which is all the stopping rule, the
stagnation damping and the best-iterate choice need), per block of
``block`` iterations for L-BFGS (the convergence measure).  The host logic
then runs in float64, exactly as the JAX package's f64 scalar logic.
Everything else stays on the device with no further synchronisation.
Capturing the iteration in a CUDA graph is later work.

SPMD mode (``group=``, the JAX package's ``axis_name``): ``x0`` is this
rank's block of a variable split over a ``torch.distributed`` group, and
``value_and_grad`` returns (the global energy, the local gradient block).
Every inner product and gradient sum is psum'd over the group, and the
host rule reads the energy the group's first rank holds
(``collectives.broadcast_scalar``), so the stopping rule, the damping and
the best iterate take the same branch on every rank: a rank that stopped
one iteration early would leave the others waiting in the next
collective.
"""

from typing import NamedTuple

import torch

__all__ = ["LBFGSState", "lbfgs_init", "lbfgs_iterations", "lbfgs_minimize",
           "TPGDState", "tpgd_init", "tpgd_step", "tpgd_iteration",
           "tpgd_minimize", "cg", "tpgd_minimize_lanes",
           "lbfgs_minimize_lanes"]

class LBFGSState(NamedTuple):
    x: torch.Tensor         # parameter array (caller's shape, preserved)
    f: torch.Tensor         # 0-d objective
    g: torch.Tensor         # gradient, shaped like x
    g_prev: torch.Tensor    # gradient before the last move
    S: torch.Tensor         # (history, *x.shape) step ring buffer
    Y: torch.Tensor         # (history, *x.shape) gradient-difference buffer
    rho: torch.Tensor       # (history,) 1/(y.s); 0 marks an empty slot
    H_diag: torch.Tensor    # 0-d initial inverse-Hessian scale
    t_prev: torch.Tensor    # last step size taken
    d_prev: torch.Tensor    # last direction taken
    n_iter: int             # L-BFGS iterations so far


def lbfgs_init(value_and_grad, x0, history=8):
    f0, g0 = value_and_grad(x0)
    g0 = g0.reshape(x0.shape)
    z = dict(dtype=x0.dtype, device=x0.device)
    return LBFGSState(
        x=x0, f=f0, g=g0, g_prev=g0,
        S=torch.zeros((history,) + tuple(x0.shape), **z),
        Y=torch.zeros((history,) + tuple(x0.shape), **z),
        rho=torch.zeros((history,), **z), H_diag=torch.ones((), **z),
        t_prev=torch.zeros((), **z), d_prev=torch.zeros_like(x0), n_iter=0)


def _sum(x, group=None):
    """Full sum of ``x``, psum'd over ``group`` in SPMD mode."""
    s = torch.sum(x)
    if group is None:
        return s
    from ..parallel.collectives import psum
    return psum(s, group)


def _host(f, group=None):
    """The scalar ``f`` on the host; in SPMD mode the group's first rank's
    value, the same on every rank."""
    if group is None:
        return f.item()
    from ..parallel.collectives import broadcast_scalar
    return broadcast_scalar(f, group)


def _push(buf, v):
    """Drop the oldest entry, append ``v`` (buffers stay oldest-first)."""
    return torch.cat([buf[1:], v.unsqueeze(0)])


def _two_loop(g, S, Y, rho, H_diag, M=None, group=None):
    """Two-loop recursion d = -H g over the masked ring buffers, oldest
    first; ``M`` applies a preconditioner as the initial inverse Hessian
    (r = H_diag M q).  Empty slots have rho = 0 and drop out."""
    history = S.shape[0]
    q = -g
    al = [None] * history
    for idx in range(history - 1, -1, -1):
        al[idx] = rho[idx] * _sum(S[idx] * q, group)
        q = q - al[idx] * Y[idx]
    r = H_diag * (q if M is None else M(q))
    for i in range(history):
        be = rho[i] * _sum(Y[i] * r, group)
        r = r + (al[i] - be) * S[i]
    return r


def lbfgs_iterations(value_and_grad, state, num_iters, lr, apply_H0=None,
                     group=None):
    """Run ``num_iters`` L-BFGS iterations (one outer step of the host
    loop).  No host synchronisation: the curvature filter is a
    ``torch.where`` selection on 0-d tensors, and whether a step is the
    first is known on the host from the iteration count."""
    st = state
    for _ in range(num_iters):
        first = st.n_iter == 0
        y = st.g - st.g_prev
        s = st.t_prev * st.d_prev
        if first:
            S_new, Y_new, rho_new, H_new = st.S, st.Y, st.rho, st.H_diag
            d = -(st.g if apply_H0 is None else apply_H0(st.g))
            t = torch.clamp(1.0 / _sum(torch.abs(st.g), group),
                            max=1.0) * lr
        else:
            ys = _sum(y * s, group)
            accept = ys > 1e-10 * _sum(s * s, group)
            S_new = torch.where(accept, _push(st.S, s), st.S)
            Y_new = torch.where(accept, _push(st.Y, y), st.Y)
            inv = torch.where(ys != 0, 1.0 / torch.where(ys != 0, ys, 1.0),
                              0.0)
            rho_new = torch.where(accept, _push(st.rho, inv), st.rho)
            yMy = _sum(y * (y if apply_H0 is None else apply_H0(y)), group)
            H_new = torch.where(accept, ys / yMy, st.H_diag)
            d = _two_loop(st.g, S_new, Y_new, rho_new, H_new, apply_H0,
                          group)
            t = torch.full((), lr, dtype=st.x.dtype, device=st.x.device)
        x_new = st.x + t * d
        f_new, g_new = value_and_grad(x_new)
        st = LBFGSState(x=x_new, f=f_new, g=g_new.reshape(st.x.shape),
                        g_prev=st.g, S=S_new, Y=Y_new, rho=rho_new,
                        H_diag=H_new, t_prev=t, d_prev=d,
                        n_iter=st.n_iter + 1)
    return st


def lbfgs_minimize(value_and_grad, x0, lr=0.1, ntol=1e-7, conv_count=3,
                   max_iter=1000, history=8, f_scale=1.0, skip_iters=5,
                   apply_H0=None, block=6, stop_fn=None, group=None):
    """L-BFGS in blocks of ``block`` iterations to convergence.

    The convergence measure is evaluated once per outer step (one block)
    and read to the host; it must satisfy ``stop_var < ntol`` for
    ``conv_count`` consecutive outer steps, checked only after
    ``skip_iters`` outer steps.  ``max_iter`` counts outer steps.
    ``stop_fn(state, f_prev) -> 0-d tensor`` replaces the default measure
    ``|dE| * f_scale``; ``group``: SPMD mode (module docstring).  Returns
    (state, n_outer_steps, converged)."""
    st = lbfgs_init(value_and_grad, x0, history)
    f_prev = st.f
    cnt = it = 0
    while cnt < conv_count and it < max_iter:
        st = lbfgs_iterations(value_and_grad, st, block, lr,
                              apply_H0=apply_H0, group=group)
        if stop_fn is None:
            stop_var = torch.abs(st.f - f_prev) * f_scale
        else:
            stop_var = stop_fn(st, f_prev)
        hit = it + 1 > skip_iters and _host(stop_var, group) < ntol
        cnt = cnt + 1 if hit else 0
        f_prev = st.f
        it += 1
    return st, it, cnt >= conv_count


class TPGDState(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor         # 0-d energy (f64 for f32 and f64 fields)
    g: torch.Tensor
    g_prev: torch.Tensor
    Mg_prev: torch.Tensor   # preconditioned previous gradient
    s_prev: torch.Tensor    # the last move, fl(x_new) - fl(x_old)
    n_iter: int


def tpgd_init(value_and_grad, x0):
    f0, g0 = value_and_grad(x0)
    zeros = torch.zeros_like(x0)
    return TPGDState(x=x0, f=f0, g=g0.reshape(x0.shape), g_prev=zeros,
                     Mg_prev=zeros, s_prev=zeros, n_iter=0)


def tpgd_step(value_and_grad, lr, state):
    """One Barzilai-Borwein (BB1) two-point gradient step, the host loop's
    TPGD: alpha = s.s / s.y, ``lr`` on the first step or where the
    curvature is zero or negative."""
    dx = state.s_prev
    num = torch.sum(dx * dx)
    den = torch.sum(dx * (state.g - state.g_prev))
    ratio = num / torch.where(den == 0, 1.0, den)
    alpha = torch.where((den == 0.0) | (ratio <= 0.0), lr, ratio)
    if state.n_iter == 0:
        alpha = torch.full_like(alpha, lr)
    x_new = state.x - alpha * state.g
    f_new, g_new = value_and_grad(x_new)
    return TPGDState(x=x_new, f=f_new, g=g_new.reshape(state.x.shape),
                     g_prev=state.g, Mg_prev=state.Mg_prev,
                     s_prev=x_new - state.x, n_iter=state.n_iter + 1)


def tpgd_iteration(value_and_grad, st, lr, apply_H0=None, scale=1.0,
                   group=None):
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
        t = torch.clamp(1.0 / _sum(torch.abs(d), group), max=1.0) * lr
    else:
        ys = _sum(y * st.s_prev, group)
        yMy = _sum(y * My, group)
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
                  max_iter=1000, f_scale=1.0, skip_iters=2, apply_H0=None,
                  stop_fn=None, stag_k=6, track_best=True, group=None):
    """Preconditioned TPGD to convergence.  Returns (state, n_iters,
    converged).  ``stop_fn(state, f_prev) -> 0-d tensor`` replaces the
    default convergence measure ``|dE| * f_scale`` (one more scalar read
    per iteration); ``group``: SPMD mode (module docstring).

    Stagnation damping: after ``stag_k`` consecutive iterations without a
    new best energy by more than the dtype's resolution (8 eps |f_best|),
    the step scale halves, forcing the iterate onto its floating-point fixed
    point so the dE rule fires.  ``track_best=True`` returns the
    lowest-energy iterate seen (its ``g`` and BB memory belong to the last
    one): the BB trajectory is non-monotone, and damping may freeze it just
    above a visited minimum.  ``track_best=False`` keeps no best iterate
    (one grid-sized buffer less) and returns the last one."""
    f0, g0 = value_and_grad(x0)
    g0 = g0.reshape(x0.shape)
    eps = torch.finfo(x0.dtype).eps
    zeros = torch.zeros_like(g0)
    st = TPGDState(x=x0, f=f0, g=g0, g_prev=g0, Mg_prev=zeros,
                   s_prev=zeros, n_iter=0)
    f_prev = _host(f0, group)
    f_best = f_prev
    best = (f0, x0) if track_best else None
    cnt = it = stag = 0
    damp = 1.0
    while cnt < conv_count and it < max_iter:
        f_prev_t = st.f
        st = tpgd_iteration(value_and_grad, st, lr, apply_H0=apply_H0,
                            scale=damp, group=group)
        f_new = _host(st.f, group)
        tol_stag = 8.0 * eps * max(abs(f_best), 1.0)
        improved = f_best - f_new > tol_stag
        if f_new < f_best:
            f_best = f_new
            if track_best:
                best = (st.f, st.x)
        stag = 0 if improved else stag + 1
        if stag >= stag_k:
            damp *= 0.5
            stag = 0
        stop_var = (abs(f_new - f_prev) * f_scale if stop_fn is None
                    else _host(stop_fn(st, f_prev_t), group))
        hit = it + 1 > skip_iters and stop_var < ntol
        cnt = cnt + 1 if hit else 0
        it += 1
        f_prev = f_new
    if track_best and f_best < f_prev:
        st = st._replace(f=best[0], x=best[1])
    return st, it, cnt >= conv_count


def cg(matvec, b, tol=1e-12, maxiter=2000, M=None, group=None):
    """Solve ``matvec(x) = b`` for a symmetric positive definite operator
    by preconditioned conjugate gradients from x = 0, stopping when
    |r| <= tol |b| or after ``maxiter`` iterations: the iteration and the
    stopping rule of ``jax.scipy.sparse.linalg.cg`` (the residual norm,
    not the preconditioned one, is tested when ``M`` is given).  A host
    loop that reads one scalar an iteration, so it runs outside every
    ``torch.func`` transform.  ``group``: SPMD mode (the inner products
    psum'd).  Returns (x, iterations)."""
    def dot(u, v):
        return _sum(u * v, group)

    bs = float(dot(b, b))
    atol2 = tol * tol * bs
    x = torch.zeros_like(b)
    r = b.clone()                     # b - A x0 with x0 = 0
    z = r if M is None else M(r)
    p = z
    gamma = dot(r, z)
    k = 0
    while k < maxiter:
        rs = float(gamma) if M is None else float(dot(r, r))
        if not rs > atol2:
            break
        Ap = matvec(p)
        alpha = gamma / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = r if M is None else M(r)
        gamma_new = dot(r, z)
        p = z + (gamma_new / gamma) * p
        gamma = gamma_new
        k += 1
    return x, k


# ------------------------------ lane batches ------------------------------
# The lane solvers carry a state whose tensors have a leading lane axis and
# whose ``n_iter`` is shared: every lane starts together, and a lane's
# n_iter only matters while it runs.  The host reads ONE (B,) energy vector
# an iteration; the stopping rule, stagnation damping and best iterate are
# kept per lane in host float64, as the serial solvers keep them.


def _lane_select(keep, new, old):
    """Per lane, ``old`` where ``keep`` (a host list of bools), else
    ``new``."""
    if not any(keep):
        return new
    mask = torch.tensor(keep, device=new.device)
    return torch.where(mask.reshape((-1,) + (1,) * (new.ndim - 1)), old, new)


def _lane_fns(value_and_grad, apply_H0, lane):
    """One lane's closures over its slices ``lane`` of the lane tensors."""
    def vg(x):
        f, g = value_and_grad(x, *lane)
        return f, g.reshape(x.shape)
    M = None if apply_H0 is None else (lambda v: apply_H0(v, *lane))
    return vg, M


def tpgd_minimize_lanes(value_and_grad, x0, lanes=(), lr=0.1, ntol=1e-7,
                        conv_count=3, max_iter=1000, f_scale=1.0,
                        skip_iters=2, apply_H0=None, stag_k=6,
                        track_best=True):
    """``tpgd_minimize`` on B lanes at once.

    ``x0`` is (B, ...); ``lanes`` is a tuple of tensors with a leading
    axis of B.  ``value_and_grad(x, *lane) -> (f, g)`` and
    ``apply_H0(v, *lane)`` see one lane: x and each entry of ``lane`` are
    that lane's slices.  Both run under ``torch.func.vmap``, so they must
    not read tensors to the host.  A lane stops when its |dE| rule holds;
    the loop ends when every lane has stopped or after ``max_iter``
    iterations.  Each lane's result is what ``tpgd_minimize`` gives for it
    with the same ``stag_k`` and ``track_best`` (to rounding: vmapped
    reductions may sum in another order).  Returns (state, iterations per
    lane, converged per lane): the state's ``x`` and ``f`` (a (B,) tensor)
    are each lane's best iterate, or its last with ``track_best=False``."""
    B = x0.shape[0]

    def init(x, *lane):
        return _lane_fns(value_and_grad, apply_H0, lane)[0](x)

    f0, g0 = torch.func.vmap(init)(x0, *lanes)
    eps = torch.finfo(x0.dtype).eps
    zeros = torch.zeros_like(g0)
    st = TPGDState(x=x0, f=f0, g=g0, g_prev=g0, Mg_prev=zeros,
                   s_prev=zeros, n_iter=0)
    f_prev = f0.tolist()
    f_best = list(f_prev)
    x_best = x0 if track_best else None
    cnt, it, stag = [0] * B, [0] * B, [0] * B
    damp = [1.0] * B
    while not all(c >= conv_count for c in cnt) and max(it) < max_iter:
        done = [c >= conv_count for c in cnt]
        n_iter = st.n_iter

        def step(x, f, g, g_prev, Mg_prev, s_prev, scale, *lane):
            vg, M = _lane_fns(value_and_grad, apply_H0, lane)
            old = TPGDState(x, f, g, g_prev, Mg_prev, s_prev, n_iter)
            return tuple(tpgd_iteration(vg, old, lr, apply_H0=M,
                                        scale=scale))[:-1]

        scale = torch.tensor(damp, dtype=x0.dtype, device=x0.device)
        new = torch.func.vmap(step)(*st[:-1], scale, *lanes)
        st = TPGDState(*(_lane_select(done, a, b)
                         for a, b in zip(new, st[:-1])), n_iter=n_iter + 1)
        f_new = st.f.tolist()
        better = [False] * B
        for b in range(B):
            if done[b]:
                continue
            tol_stag = 8.0 * eps * max(abs(f_best[b]), 1.0)
            improved = f_best[b] - f_new[b] > tol_stag
            if f_new[b] < f_best[b]:
                f_best[b], better[b] = f_new[b], True
            stag[b] = 0 if improved else stag[b] + 1
            if stag[b] >= stag_k:
                damp[b] *= 0.5
                stag[b] = 0
            hit = (it[b] + 1 > skip_iters
                   and abs(f_new[b] - f_prev[b]) * f_scale < ntol)
            cnt[b] = cnt[b] + 1 if hit else 0
            it[b] += 1
            f_prev[b] = f_new[b]
        if track_best:   # a lane's new best iterate replaces its x_best
            x_best = _lane_select(better, x_best, st.x)
    if track_best:
        take = [fb < fl for fb, fl in zip(f_best, f_prev)]
        f_out = torch.tensor([fb if t else fl for fb, fl, t in
                              zip(f_best, f_prev, take)], dtype=st.f.dtype,
                             device=st.f.device)
        st = st._replace(x=_lane_select(take, st.x, x_best), f=f_out)
    return st, it, [c >= conv_count for c in cnt]


def lbfgs_minimize_lanes(value_and_grad, x0, lanes=(), lr=0.1, ntol=1e-7,
                         conv_count=3, max_iter=1000, history=8,
                         f_scale=1.0, skip_iters=5, apply_H0=None, block=6):
    """``lbfgs_minimize`` on B lanes at once, with the lane conventions of
    :func:`tpgd_minimize_lanes`: blocks of ``block`` iterations per outer
    step, the |dE| rule per lane after ``skip_iters`` outer steps, a
    stopped lane frozen.  Returns (state, outer steps per lane, converged
    per lane)."""
    B = x0.shape[0]

    def init(x, *lane):
        vg = _lane_fns(value_and_grad, apply_H0, lane)[0]
        return tuple(lbfgs_init(vg, x, history))[:-1]

    st = LBFGSState(*torch.func.vmap(init)(x0, *lanes), n_iter=0)
    f_prev = st.f.tolist()
    cnt, it = [0] * B, [0] * B
    while not all(c >= conv_count for c in cnt) and max(it) < max_iter:
        done = [c >= conv_count for c in cnt]
        n_iter = st.n_iter

        def step(*args):
            fields, lane = args[:10], args[10:]
            vg, M = _lane_fns(value_and_grad, apply_H0, lane)
            old = LBFGSState(*fields, n_iter=n_iter)
            return tuple(lbfgs_iterations(vg, old, block, lr,
                                          apply_H0=M))[:-1]

        new = torch.func.vmap(step)(*st[:-1], *lanes)
        st = LBFGSState(*(_lane_select(done, a, b)
                          for a, b in zip(new, st[:-1])),
                        n_iter=n_iter + block)
        f_new = st.f.tolist()
        for b in range(B):
            if done[b]:
                continue
            hit = (it[b] + 1 > skip_iters
                   and abs(f_new[b] - f_prev[b]) * f_scale < ntol)
            cnt[b] = cnt[b] + 1 if hit else 0
            it[b] += 1
            f_prev[b] = f_new[b]
    return st, it, [c >= conv_count for c in cnt]
