"""Autodiff utilities: functional derivatives, linear response, stress and
pressure of a functional.

PyTorch port of ``professad_tpu/ops/autodiff.py``.  ``torch.func.grad``
takes the place of ``jax.grad`` (nested where the JAX package nests it),
so every result composes with further ``torch.func`` transforms, and
``.detach()`` takes the place of ``jax.lax.stop_gradient``.  The energies
go through ``torch.fft``, never the spectral-convolution kernel, which has
no forward-mode rule.
"""

import numpy as np
import torch

from .grid import wavevecs, volume, safe_sqrt

__all__ = ["get_functional_derivative", "get_inv_G", "get_stress",
           "get_pressure"]


def get_functional_derivative(box_vecs, den, functional):
    """delta F / delta n(r) via one reverse-mode pass, divided by the grid
    quadrature weight vol / N_grid."""
    g = torch.func.grad(lambda n: functional(box_vecs, n))(den)
    return g / (volume(box_vecs) / den.numel())


def get_inv_G(box_vecs, den, kinetic_functional):
    """Linear response G^-1(eta) of a kinetic functional about the uniform
    density of the same electron count, from two nested reverse passes.

    A functional whose owner has ``prepare`` (the ladder terms and MGP)
    first caches its ladder or kernel from that uniform density, as in the
    JAX package, and is then evaluated on that cached ladder
    (``forward_static``).  Returns (eta, G_inv) on the rfftn half-spectrum
    grid."""
    vol = volume(box_vecs)
    _, _, _, k2 = wavevecs(box_vecs, den.shape)
    N_elec = round(float(torch.mean(den) * vol))
    n0 = torch.full(den.shape, float(N_elec / vol), dtype=den.dtype,
                    device=den.device)
    k_F = (3.0 * np.pi**2 * N_elec / vol) ** (1.0 / 3.0)

    owner = getattr(kinetic_functional, "__self__", kinetic_functional)
    fn = kinetic_functional
    if callable(getattr(owner, "prepare", None)):
        owner.prepare(box_vecs, n0)
        if hasattr(owner, "forward_static"):
            fn = owner.forward_static

    def dTdn_000(n):
        g = torch.func.grad(lambda m: fn(box_vecs, m))(n)
        return (g / (vol / n.numel()))[0, 0, 0]

    d2T = torch.func.grad(dTdn_000)(n0)
    G_inv = np.pi**2 / k_F / torch.fft.rfftn(d2T).real
    eta = safe_sqrt(k2) / (2.0 * k_F)
    return eta, G_inv


def get_stress(box_vecs, den, functional):
    """Stress of a functional, sigma = (dF/dh)^T h / vol, with the density
    rescaled by vol0 / vol(h) so that the electron number stays fixed."""
    vol0 = volume(box_vecs).detach()

    def F(h):
        return functional(h, den * vol0 / volume(h))

    dEdcell = torch.func.grad(F)(box_vecs).T
    return dEdcell @ box_vecs / vol0


def get_pressure(box_vecs, den, functional):
    """Pressure of a functional, P = -dF/dvol at fixed electron number
    under an isotropic scaling of the cell."""
    vol0 = volume(box_vecs).detach()

    def F(v):
        scale = (v / vol0) ** (1.0 / 3.0)
        return functional(box_vecs * scale, den * vol0 / v)

    return -torch.func.grad(F)(vol0)
