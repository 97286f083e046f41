"""Neural-network kinetic functional: an MLP Pauli enhancement factor.

PyTorch port of ``professad_tpu/models/neural.py``: the semi-local
functional T = T_vW + int F_theta(s, q) tau_TF, where F_theta is a small
MLP over the reduced gradient s and reduced Laplacian q, with SiLU hidden
activations and a softplus output (F >= 0: Pauli positivity).  The
weights are float64 ``nn.Parameter``s drawn from
``np.random.default_rng(seed)`` exactly as in the JAX package, so both
packages start from the same network.
"""

import numpy as np
import torch
from torch.nn import functional as F

from ..ops.grid import (wavevecs, volume, qmean, reduced_gradient,
                        reduced_laplacian)
from .base import KineticFunctional
from .kinetic_local import Weizsaecker, TF_COEFF

__all__ = ["NeuralNetworkFunctional"]


class NeuralNetworkFunctional(KineticFunctional):
    """T = T_vW + int F_theta(s, q) tau_TF; F_theta = softplus MLP with
    hidden widths ``init_args`` (default [16, 16])."""

    def __init__(self, init_args=None, seed=0):
        super().__init__(init_args)
        inner = list(init_args) if init_args is not None else [16, 16]
        self.init_args = inner
        sizes = [2] + inner + [1]
        rng = np.random.default_rng(seed)
        params = {}
        for i in range(len(sizes) - 1):
            params[f"W{i}"] = (rng.normal(size=(sizes[i], sizes[i + 1]))
                               / np.sqrt(sizes[i]))
            params[f"b{i}"] = np.zeros((sizes[i + 1],))
        self.n_layers = len(sizes) - 1
        self._init_params(params)

    def enhancement_factor(self, params, s, q):
        """F_theta(s, q) >= 0 on the grid."""
        h = torch.stack([s, q], dim=-1)
        for i in range(self.n_layers):
            h = h @ params[f"W{i}"].to(h.dtype) + params[f"b{i}"].to(h.dtype)
            if i != self.n_layers - 1:
                h = F.silu(h)
        # log(1 + e^h) without a threshold, as jax.nn.softplus
        return torch.logaddexp(h[..., 0], torch.zeros_like(h[..., 0]))

    def apply(self, params, box_vecs, den):
        kx, ky, kz, k2 = wavevecs(box_vecs, den.shape)
        s = reduced_gradient(kx, ky, kz, den)
        q = reduced_laplacian(k2, den)
        F_enh = self.enhancement_factor(params, s, q)
        TF_ked = TF_COEFF * den ** (5.0 / 3.0)
        pauli_T = qmean(F_enh * TF_ked) * volume(box_vecs)
        return Weizsaecker(box_vecs, den) + pauli_T
