"""Implicit differentiation through the density-optimization ground state.

PyTorch port of ``professad_tpu/ops/implicit.py``.  The converged chi* is a
function of parameters theta (volume, cell, ion positions, a functional's
parameters) through the stationarity condition grad_chi E(chi*, theta) = 0,
so by the implicit function theorem

    d chi* = -H^{-1} (d/dtheta grad_chi E) dtheta,

with H the chi-Hessian.  Each Hessian solve is a preconditioned CG
(``solvers.cg``, the ``jax.scipy`` stopping rule) on Hessian-vector
products taken by double backward through one retained graph of the chi
gradient.  The CG reads a scalar an iteration and the preconditioner is
the spectral-convolution kernel (an autograd Function with no forward-mode
rule), so every solve runs outside ``torch.func`` transforms:

* ``implicit_ground_state``: chi* as an autograd Function whose backward
  is one adjoint solve (reverse mode: gradients of ground-state
  properties, ``System.gs_property_fn``);
* ``ground_state_hessian``: the first derivative and rows of the Hessian
  of E(chi*(theta), theta) in closed form, E_tt - b^T H^+ b with
  b = d/dtheta grad_chi E, one solve per row (``System.bulk_modulus``,
  ``elastic_constants``, ``force_constants``).  The JAX package's
  forward-over-reverse chain adds grad_chi E . d(chi*)/dtheta-type terms of
  the order of the density residual, which this form drops;
* ``newton_refined_ground_state``: chi*(theta) as the Newton map
  c - H(c, theta)^{-1} grad_chi E(c, theta), its solve an autograd
  Function whose backward is the same Function, so derivatives of every
  order exist (``System.gs_volume_property_fn``).

Gauge: n = N chi^2 / int chi^2 is scale invariant, so H has a zero mode
along chi.  It is projected out of the right-hand side and the solution,
and the solve adds the rank-one shift c chi^ chi^T with c = |H v0|, v0 a
unit probe orthogonal to chi^, as in the JAX package.

``solves`` records (CG iterations, relative residual) of every solve in
this process; after each solve of the first two routes one more
Hessian-vector product measures |A x - b| / |b|, and a value above
``check_tol`` prints the JAX package's warning to stderr.

``ground_state_hessian(..., group=)`` runs SPMD on a ``torch.distributed``
group: chi is this rank's slab, ``energy_fn`` returns the replicated
global energy, and each rank differentiates its share of it
(``parallel/collectives.py``): inner products and norms are psum'd, and
the derivatives with respect to theta (held whole on every rank) are the
psum of the ranks' parts.
"""

import sys

import torch

from .solvers import cg

__all__ = ["implicit_ground_state", "newton_refined_ground_state",
           "ground_state_hessian", "solves"]

solves = []


def _warn_residual(rel, tol):
    print(f"WARNING: implicit_ground_state: CG Hessian solve stagnated "
          f"(relative residual {rel:.3e} > {tol:.1e}); implicit second "
          f"derivatives may be inaccurate — check preconditioning / Hessian "
          f"conditioning.", file=sys.stderr, flush=True)


def _dot(u, v, group=None):
    s = torch.sum(u * v)
    if group is None:
        return s
    from ..parallel.collectives import psum
    return psum(s, group)


def _norm(v, group=None):
    if group is None:
        return torch.linalg.norm(v)
    return torch.sqrt(_dot(v, v, group))


def _project(v, chihat, group=None):
    return v - _dot(chihat, v, group) * chihat


def _roll1(x, group=None):
    """``torch.roll(x, 1)`` of the flattened vector; on a group, of the
    global vector whose row-major blocks the ranks hold."""
    r = torch.roll(x, 1)
    if group is None:
        return r
    from ..parallel.collectives import all_gather, axis_index, axis_size
    lasts = all_gather(x.reshape(-1)[-1:], 0, group)
    r = r.reshape(-1).clone()
    r[0] = lasts[(axis_index(group) - 1) % axis_size(group)]
    return r.reshape(x.shape)


def _probe(chihat, group=None):
    """Unit probe orthogonal to chi^: chi^ rolled by one, or where that
    degenerates (a near-uniform chi) a sinusoidal grid vector."""
    v0 = _project(_roll1(chihat, group), chihat, group)
    nrm = _norm(v0, group)
    if float(nrm) > 1e-7:
        return v0 / (nrm + 1e-300)
    start = 0
    if group is not None:
        from ..parallel.collectives import axis_index
        start = axis_index(group) * chihat.numel()
    alt = torch.sin(torch.arange(start, start + chihat.numel(),
                                 dtype=chihat.dtype, device=chihat.device)
                    ).reshape(chihat.shape)
    alt = _project(alt, chihat, group)
    return alt / (_norm(alt, group) + 1e-300)


def _flatten(tree):
    """The tensor leaves of nested tuples, lists and mappings, and a
    function that rebuilds the tree (mappings as dicts) from new leaves;
    anything else is a constant."""
    if torch.is_tensor(tree):
        return [tree], lambda xs: xs[0]
    if isinstance(tree, (tuple, list)):
        keys, parts = None, [_flatten(t) for t in tree]
    elif hasattr(tree, "items"):
        keys = list(tree.keys())
        parts = [_flatten(tree[k]) for k in keys]
    else:
        return [], lambda xs: tree
    counts = [len(p[0]) for p in parts]

    def rebuild(xs):
        out, i = [], 0
        for (_, rb), n in zip(parts, counts):
            out.append(rb(xs[i:i + n]))
            i += n
        return type(tree)(out) if keys is None else dict(zip(keys, out))
    return [x for p in parts for x in p[0]], rebuild


class _ChiHessian:
    """v -> H v at (c, args) by double backward through one retained
    graph of g = grad_chi E; ``g`` and ``chi`` stay available for the
    mixed derivatives d/dargs <g, u>."""

    def __init__(self, energy_fn, c, args):
        with torch.enable_grad():
            self.chi = c.detach().requires_grad_(True)
            E = energy_fn(self.chi, *args)
            (self.g,) = torch.autograd.grad(E, self.chi, create_graph=True)

    def __call__(self, v):
        with torch.enable_grad():
            (hv,) = torch.autograd.grad(self.g, self.chi, grad_outputs=v,
                                        retain_graph=True)
        return hv


class _Solver:
    """The shifted, preconditioned solve A x = rhs, A = H + c chi^ chi^T."""

    def __init__(self, chihat, cg_tol, cg_maxiter, precond, check_tol,
                 group=None):
        self.chihat = chihat
        self.cg_tol, self.cg_maxiter = cg_tol, cg_maxiter
        self.precond, self.check_tol = precond, check_tol
        self.group = group
        self.shift = None

    def __call__(self, hvp, rhs):
        chihat, group = self.chihat, self.group
        if self.shift is None:
            self.shift = float(_norm(hvp(_probe(chihat, group)),
                                     group)) + 1e-30

        def matvec(v):
            return hvp(v) + self.shift * _dot(chihat, v, group) * chihat
        x, k = cg(matvec, rhs, self.cg_tol, self.cg_maxiter, self.precond,
                  group=group)
        rel = None
        if self.check_tol is not None:
            rel = float(_norm(matvec(x) - rhs, group)
                        / (_norm(rhs, group) + 1e-300))
            if rel > self.check_tol:
                _warn_residual(rel, self.check_tol)
        solves.append((k, rel))
        return x


def _detached(leaves):
    return [t.detach() for t in leaves]


class _ImplicitChi(torch.autograd.Function):
    """chi* = chi0 in value; backward: theta_bar = -d/dtheta <grad_chi E,
    lam> with lam = P A^{-1} P w (one adjoint solve)."""

    @staticmethod
    def forward(ctx, spec, chi0, *leaves):
        ctx.spec = spec
        ctx.save_for_backward(chi0, *leaves)
        return chi0.clone()

    @staticmethod
    def backward(ctx, w):
        chi0, *leaves = ctx.saved_tensors
        energy_fn, rebuild, solve = ctx.spec
        needs = ctx.needs_input_grad[2:]
        grads = [None] * len(leaves)
        if not any(needs):
            return (None, None, *grads)
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(n) for t, n in zip(leaves, needs)]
            H = _ChiHessian(energy_fn, chi0, rebuild(xs))
            chihat = solve.chihat
            lam = _project(solve(H, _project(w, chihat)), chihat)
            want = [x for x, n in zip(xs, needs) if n]
            got = torch.autograd.grad(_dot(H.g, lam), want, allow_unused=True)
        got = iter(got)
        for i, n in enumerate(needs):
            if n:
                g = next(got)
                grads[i] = None if g is None else -g
        return (None, None, *grads)


def implicit_ground_state(energy_fn, chi_opt, args=(), cg_tol=1e-12,
                          cg_maxiter=2000, precond=None, check_tol=1e-6):
    """Mark a converged chi as the stationary point of ``energy_fn``.

    ``energy_fn(chi, *args)`` is the energy of the unconstrained
    sqrt-density chi; ``args`` (tensors, or tuples, lists and dicts of
    them) are the parameters.  ``precond`` is an SPD approximate inverse
    Hessian applied as the CG preconditioner (``System._exact_precond``).
    ``check_tol``: the relative residual above which each solve warns
    (None: no check).  Returns chi_opt as a tensor whose backward supplies
    d chi*/d args by the implicit function theorem (reverse mode; second
    derivatives of the ground-state energy: ``ground_state_hessian``)."""
    chi0 = chi_opt.detach()
    chihat = chi0 / torch.linalg.norm(chi0)
    leaves, rebuild = _flatten(args)
    solve = _Solver(chihat, cg_tol, cg_maxiter, precond, check_tol)
    return _ImplicitChi.apply((energy_fn, rebuild, solve), chi0, *leaves)


def ground_state_hessian(energy_fn, chi_opt, theta, rows=None, cg_tol=1e-12,
                         cg_maxiter=2000, precond=None, check_tol=1e-6,
                         group=None):
    """First derivative and Hessian rows of the ground-state energy
    Ebar(theta) = E(chi*(theta), theta) at the converged ``chi_opt``.

    ``energy_fn(chi, theta)`` with ``theta`` one tensor (flattened to m
    components); ``rows``: the components i whose rows are wanted (all by
    default).  Returns (dE/dtheta at fixed chi, shape (m,); the rows
    d2Ebar/dtheta_i dtheta_j = E_ij + b_j . u_i, shape (len(rows), m)),
    with b_i = P d/dtheta_i grad_chi E and u_i = -P A^{-1} b_i: one CG
    solve per row.  ``group``: SPMD mode (module docstring), ``chi_opt``
    this rank's slab."""
    from ..parallel.collectives import psum, rank_share

    def total(part):
        return part if group is None else psum(part, group)

    chi = chi_opt.detach().requires_grad_(True)
    th = theta.detach().requires_grad_(True)
    with torch.enable_grad():
        E = energy_fn(chi, th)
        if group is not None:
            E = rank_share(E, group)
        g_chi, g_th = torch.autograd.grad(E, (chi, th), create_graph=True)
    g_th = g_th.reshape(-1)
    m = g_th.numel()
    chihat = chi.detach() / _norm(chi.detach(), group)
    solve = _Solver(chihat, cg_tol, cg_maxiter, precond, check_tol, group)

    def grad_or_zero(out, wrt):
        with torch.enable_grad():
            (d,) = torch.autograd.grad(out, wrt, retain_graph=True,
                                       allow_unused=True)
        return torch.zeros_like(wrt) if d is None else d

    def hvp(v):
        return torch.autograd.grad(g_chi, chi, grad_outputs=v,
                                   retain_graph=True)[0]

    rows = list(range(m)) if rows is None else list(rows)
    out = torch.empty((len(rows), m), dtype=g_th.dtype, device=g_th.device)
    for a, i in enumerate(rows):
        b = _project(grad_or_zero(g_th[i], chi), chihat, group)
        u = _project(solve(hvp, -b), chihat, group)
        with torch.enable_grad():
            # on a group: this rank's part of the row's objective
            mixed = g_th[i] + _dot(g_chi, u)
        out[a] = total(grad_or_zero(mixed, th).reshape(-1))
    return total(g_th.detach()), out


class _LinearSolve(torch.autograd.Function):
    """x = A(c, theta)^{-1} r with A = H(c, theta) + shift chi^ chi^T
    (symmetric; the shift a constant).  Backward: lam = the same Function
    on the cotangent, r_bar = lam, (c, theta)_bar = -d/d(c, theta)
    <lam, H(c, theta) x>, all differentiable, so ``create_graph``
    differentiates it again."""

    @staticmethod
    def forward(ctx, spec, r, c, *leaves):
        energy_fn, rebuild, solve = spec
        H = _ChiHessian(energy_fn, c, rebuild(_detached(leaves)))
        x = solve(H, r.detach())
        ctx.spec = spec
        ctx.save_for_backward(x, c, *leaves)
        return x

    @staticmethod
    def backward(ctx, x_bar):
        x, c, *leaves = ctx.saved_tensors
        energy_fn, rebuild, solve = ctx.spec
        needs = ctx.needs_input_grad
        lam = _LinearSolve.apply(ctx.spec, x_bar, c, *leaves)
        grads = [None] * (1 + len(leaves))
        idx = [i for i in range(len(grads)) if needs[2 + i]]
        if idx:
            create = torch.is_grad_enabled()
            with torch.enable_grad():
                # partial derivatives at fixed (lam, x): differentiate with
                # respect to zero perturbations of the inputs, so that the
                # paths through lam(theta) and x(theta) are not followed
                inputs = [c, *leaves]
                deltas = {i: torch.zeros_like(inputs[i]).requires_grad_(True)
                          for i in idx}
                moved = [t + deltas[i] if i in deltas else t
                         for i, t in enumerate(inputs)]
                cc = moved[0] if 0 in deltas else \
                    c.detach().requires_grad_(True)
                E = energy_fn(cc, *rebuild(moved[1:]))
                (g,) = torch.autograd.grad(E, cc, create_graph=True)
                (hx,) = torch.autograd.grad(g, cc, grad_outputs=x,
                                            create_graph=True)
                got = torch.autograd.grad(_dot(lam, hx),
                                          [deltas[i] for i in idx],
                                          create_graph=create,
                                          allow_unused=True)
            for i, gi in zip(idx, got):
                grads[i] = None if gi is None else -gi
        return (None, lam if needs[1] else None, *grads)


def newton_refined_ground_state(energy_fn, chi_opt, args=(), cg_tol=1e-12,
                                cg_maxiter=2000, precond=None, steps=1):
    """chi*(theta) as an explicitly differentiable Newton map, for mixed
    derivatives of third order (d(bulk modulus)/d(functional params)).

    chi ~= N(chi0, theta) with chi0 the converged chi held constant and
    N(c, theta) = c - P A(c, theta)^{-1} P grad_chi E(c, theta), applied
    ``steps`` times.  Its derivatives of every order are those of this
    closed form, which agree with the true chi*(theta) to
    O(|chi0 - chi*|).  Each differentiation pass costs one more solve per
    step; no residual check (as in the JAX package)."""
    chi0 = chi_opt.detach()
    chihat = chi0 / torch.linalg.norm(chi0)
    leaves, rebuild = _flatten(args)
    chi = chi0
    for _ in range(steps):
        with torch.enable_grad():
            cc = chi if chi.requires_grad else chi.detach().requires_grad_(
                True)
            E = energy_fn(cc, *rebuild(leaves))
            (g,) = torch.autograd.grad(E, cc, create_graph=True)
        solve = _Solver(chihat, cg_tol, cg_maxiter, precond, None)
        u = _LinearSolve.apply((energy_fn, rebuild, solve),
                               _project(g, chihat), chi, *leaves)
        chi = chi - _project(u, chihat)
    return chi
