"""Differentiable collectives over a ``torch.distributed`` process group.

The port's counterparts of ``lax.all_to_all`` (tiled), ``lax.psum`` and
``lax.axis_index``, which the JAX package's ``shard_map`` bodies call.  The
port runs SPMD: one process per device, every rank calling the same code on
its own slab.  ``all_to_all`` and ``psum`` are ``torch.autograd.Function``s
whose backward applies the Function again (the inverse ``all_to_all``; the
``psum`` of the cotangents), so ``create_graph`` differentiates them once
more and the Hessian-vector products of the second derivatives run through
them.  Both are linear, so their forward-mode rule is the Function itself.

**Differentiating a distributed energy.**  The energy is a replicated
scalar: its sums are ``psum``s in the graph, so every rank holds the same
value.  Differentiating it on every rank would scale every gradient by the
group size P: the backward of each ``psum`` adds P unit cotangents.  So a
rank differentiates its share of it, ``rank_share(E) = E / P``; the shares
sum to E, and the backward passes of the collectives carry the other
ranks' contributions to each rank's slab, which gets its whole gradient.
A parameter every rank holds whole (the cell, the ion positions) gets the
rank's part of its gradient: the gradient is the ``psum`` of the parts.
An objective that is itself a sum of local parts (an inner product of two
split vectors) is differentiated part by part, with no 1/P.  These are
the rules of the JAX package's ``shard_map`` transpose, under which the
same all-reduce sits in ``pfft.pchi_value_and_grad_terms`` as a division
of the gradient by the axis size.
"""

import torch
import torch.distributed as dist

__all__ = ["all_to_all", "psum", "rank_share", "axis_index", "axis_size",
           "all_gather", "broadcast_scalar"]


def axis_size(group):
    """Number of ranks in ``group``."""
    return dist.get_world_size(group)


def axis_index(group):
    """This process's rank within ``group``."""
    return dist.get_rank(group)


def _as_real(x):
    return torch.view_as_real(x) if x.is_complex() else x


def _all_to_all(x, split_axis, concat_axis, group):
    """Tiled all-to-all: split ``x`` into P chunks along ``split_axis``,
    send chunk j to rank j, concatenate the received chunks in rank order
    along ``concat_axis`` (``lax.all_to_all(..., tiled=True)``)."""
    p = axis_size(group)
    nd = x.ndim
    split_axis %= nd
    concat_axis %= nd
    if x.shape[split_axis] % p:
        raise ValueError(f"all_to_all: axis {split_axis} of {tuple(x.shape)} "
                         f"does not divide by the group size {p}")
    send = _as_real(x.movedim(split_axis, 0).contiguous())
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if x.is_complex():
        recv = torch.view_as_complex(recv)
    rest = [s for i, s in enumerate(x.shape) if i != split_axis]
    y = recv.reshape([p, x.shape[split_axis] // p] + rest)
    # y[p, ...] is the chunk rank p sent, in x's axis order with the split
    # axis reduced; put that axis back, then lay the chunks along concat
    z = y.movedim(1, split_axis + 1).movedim(0, concat_axis)
    shape = list(z.shape)
    shape[concat_axis:concat_axis + 2] = [shape[concat_axis]
                                          * shape[concat_axis + 1]]
    return z.reshape(shape)


class _AllToAll(torch.autograd.Function):

    @staticmethod
    def forward(x, split_axis, concat_axis, group):
        return _all_to_all(x, split_axis, concat_axis, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.split_axis, ctx.concat_axis, ctx.group = inputs

    @staticmethod
    def backward(ctx, g):
        return (_AllToAll.apply(g, ctx.concat_axis, ctx.split_axis,
                                ctx.group), None, None, None)

    @staticmethod
    def jvp(ctx, t, *_):
        return _AllToAll.apply(t, ctx.split_axis, ctx.concat_axis, ctx.group)


def all_to_all(x, split_axis, concat_axis, group):
    """Differentiable tiled all-to-all (see ``_all_to_all``); complex
    tensors travel as their real view."""
    return _AllToAll.apply(x, split_axis, concat_axis, group)


class _PSum(torch.autograd.Function):

    @staticmethod
    def forward(x, group):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _PSum.apply(g, ctx.group), None

    @staticmethod
    def jvp(ctx, t, _):
        return _PSum.apply(t, ctx.group)


def psum(x, group):
    """Differentiable all-reduce of a sum over ``group``: every rank gets
    the same value; the backward is ``psum`` of the cotangents."""
    return _PSum.apply(x, group)


def rank_share(x, group):
    """This rank's share x / P of a replicated scalar: the objective a rank
    differentiates (module docstring)."""
    return x / axis_size(group)


def all_gather(x, axis, group):
    """Concatenate every rank's ``x`` along ``axis`` in rank order (no
    gradient; the ranks' shapes must agree)."""
    parts = [torch.empty_like(x) for _ in range(axis_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=axis)


def broadcast_scalar(x, group):
    """``x`` (a 0-d tensor) as the group's first rank holds it, as a
    Python float on every rank: the one value the host rules read."""
    y = x.detach().reshape(1).clone()
    dist.broadcast(y, src=dist.get_global_rank(group, 0), group=group)
    return float(y)
