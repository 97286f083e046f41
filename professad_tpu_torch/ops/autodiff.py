"""Autodiff utilities for functional derivatives.

PyTorch port of ``professad_tpu/ops/autodiff.py::get_functional_derivative``.
``torch.func.grad`` takes the place of ``jax.grad``, so the result composes
with further ``torch.func`` transforms as the JAX one does.
"""

import torch

from .grid import volume

__all__ = ["get_functional_derivative"]


def get_functional_derivative(box_vecs, den, functional):
    """delta F / delta n(r) via one reverse-mode pass, divided by the grid
    quadrature weight vol / N_grid."""
    g = torch.func.grad(lambda n: functional(box_vecs, n))(den)
    return g / (volume(box_vecs) / den.numel())
