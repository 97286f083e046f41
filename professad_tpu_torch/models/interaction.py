"""Electrostatic interaction energy terms.

PyTorch port of ``professad_tpu/models/interaction.py``.  Every term is a
function E(box_vecs, den[, v_ext]) using the quadrature
mean(integrand) * |det h|.
"""

import numpy as np
import torch

from ..ops.grid import wavevecs, volume, qmean, rfftn, irfftn

__all__ = ["IonIon", "IonElectron", "Hartree", "hartree_potential"]


def IonIon():
    """Marker term: requests the real-space ion-ion interaction sum, which
    ``System`` dispatches to ``models.ions.ion_interaction_sum``."""
    return None


def IonElectron(box_vecs, den, v_ext):
    """U_ie = int n(r) v_ext(r) d3r."""
    return qmean(den * v_ext) * volume(box_vecs)


def _coulomb_ft(k2):
    """4 pi / k^2 with the k=0 component zeroed (neutralising background)."""
    nz = k2 != 0
    return torch.where(nz, 4.0 * np.pi / torch.where(nz, k2, 1.0), 0.0)


def hartree_potential(box_vecs, den):
    """Classical electrostatic potential of the density (k=0 removed)."""
    _, _, _, k2 = wavevecs(box_vecs, den.shape)
    return irfftn(rfftn(den) * _coulomb_ft(k2), den.shape)


def Hartree(box_vecs, den):
    """U_H = 1/2 int int n(r) n(r') / |r - r'|."""
    pot = hartree_potential(box_vecs, den)
    return 0.5 * qmean(den * pot) * volume(box_vecs)
