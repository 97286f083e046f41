"""Ion-related utilities: recpot pseudopotentials, the exact structure
factor, lattice sums and the real-space ion-ion interaction.

PyTorch port of the subset of ``professad_tpu/models/ions.py`` on the
density-optimization path.  The particle-mesh Ewald structure factor is not
ported yet (``lattice_sum`` raises for ``order`` other than None).
"""

import numpy as np
import torch

from ..ops.grid import wavevecs, volume, safe_sqrt
from ..utils.constants import RECPOT_BOHR, RECPOT_POT_CONV

__all__ = ["read_recpot", "get_ion_charge", "structure_factor",
           "lattice_sum", "neighbor_shifts", "ion_interaction_sum"]

_MAX_PAIRS = 1 << 22  # pair terms per chunk of the ion-ion image sum


def read_recpot(path):
    """Parse a CASTEP-style .recpot file (host-side numpy).

    Returns (ks, pot_ft, z): the k grid [1/bohr], the tabulated local
    pseudopotential with the Coulomb tail ADDED back (so the table is
    smooth), and the inferred ion charge."""
    values = []
    with open(path, "r") as fh:
        for line in fh:
            if "END COMMENT" in line:
                break
        fh.readline()  # the '3     5' version line
        k_max = float(fh.readline()) * RECPOT_BOHR
        for line in fh:
            parts = line.split()
            if len(parts) == 3:
                values += parts
    pot_ft = np.asarray(values, dtype=np.float64) * RECPOT_POT_CONV
    if pot_ft.size < 3:
        raise ValueError(f"recpot '{path}': too few tabulated values")
    ks, dk = np.linspace(0.0, k_max, pot_ft.size, retstep=True)
    # Z from the k->0 Coulomb limit V(k) - V(0) ~ -4 pi Z / k^2, anchored at
    # two small-k points so a malformed table raises
    z1 = (pot_ft[1] - pot_ft[0]) * dk * dk / (-4.0 * np.pi)
    z2 = (pot_ft[2] - pot_ft[0]) * (2.0 * dk) ** 2 / (-4.0 * np.pi)
    z = round(z1)
    if z < 0 or round(z2) != z or (z > 0 and abs(z1 - z) > 0.05 * z):
        raise ValueError(
            f"recpot '{path}': inconsistent k->0 Coulomb tail "
            f"(Z estimates {z1:.4f} and {z2:.4f}); file may be malformed")
    pot_ft = pot_ft.copy()
    pot_ft[1:] += 4.0 * np.pi * z / (ks[1:] * ks[1:])
    return ks, pot_ft, z


def get_ion_charge(path):
    """Ion charge Z from the k->0 limit -4 pi Z / k^2."""
    return read_recpot(path)[2]


def structure_factor(box_vecs, shape, cart_ion_coords):
    """Exact O(N_grid * N_ions) structure factor S(q) = sum_i e^{-i q.r_i}
    on the rfftn half-spectrum grid."""
    kx, ky, kz, _ = wavevecs(box_vecs, shape)
    kr = (kx[..., None] * cart_ion_coords[:, 0]
          + ky[..., None] * cart_ion_coords[:, 1]
          + kz[..., None] * cart_ion_coords[:, 2])
    return torch.complex(torch.cos(kr).sum(-1), -torch.sin(kr).sum(-1))


def lattice_sum(box_vecs, shape, cart_ion_coords, f_tilde, order=None):
    """F(r) = irfftn(S(q) f~(q)) / vol with the unscaled inverse transform
    (``norm="forward"``), exact structure factor."""
    if order is not None:
        raise NotImplementedError(
            "particle-mesh Ewald (pme_order) is not ported yet: ROADMAP A8")
    S = structure_factor(box_vecs, shape, cart_ion_coords)
    return (torch.fft.irfftn(S * f_tilde, s=tuple(shape), norm="forward")
            / volume(box_vecs))


def neighbor_shifts(box_vecs, Rc):
    """Static table of periodic-image shifts (lattice units) covering a
    sphere of radius Rc; host-side numpy from a concrete cell."""
    bv = np.asarray(box_vecs, dtype=np.float64)
    inv_T = np.linalg.inv(bv.T)
    h = 1.0 / np.sqrt(np.sum(inv_T**2, axis=1))
    n = np.ceil(float(Rc) / h).astype(int) + 1
    grids = np.meshgrid(*(np.arange(-ni, ni + 1) for ni in n), indexing="ij")
    shifts = np.stack([g.reshape(-1) for g in grids],
                      axis=1).astype(np.float64)
    # keep only images whose closest approach to the home cell can be < Rc
    centers = shifts @ bv
    diam = np.sqrt(3.0) * np.max(np.linalg.norm(bv, axis=1))
    keep = np.linalg.norm(centers, axis=1) <= float(Rc) + diam
    return shifts[keep]


def ion_interaction_sum(box_vecs, coords, charges, Rc, Rd, shifts=None):
    """Real-space damped pairwise electrostatic sum in a neutralising
    background (Witt et al., PRMaterials 2, 013806):

    E = 1/2 sum_{i != j, |r_ij| < Rc} Z_i Z_j erfc(r_ij / Rd) / r_ij
        + per-ion adaptive-radius correction terms.

    ``shifts`` (lattice-unit image table) defaults to
    :func:`neighbor_shifts` of the concrete cell; the images are summed in
    chunks of at most ``_MAX_PAIRS`` pair terms (bounded memory).
    Differentiable with respect to ``coords`` and ``box_vecs``."""
    if shifts is None:
        shifts = neighbor_shifts(box_vecs.detach().cpu().numpy(), Rc)
    n_ions = coords.shape[0]
    dtype, device = coords.dtype, coords.device
    shifts_t = torch.as_tensor(np.asarray(shifts), dtype=dtype, device=device)
    chunk = max(1, _MAX_PAIRS // (n_ions * n_ions))
    zz = charges[:, None] * charges[None, :]

    E_local = torch.zeros((), dtype=dtype, device=device)
    Qi = torch.zeros(n_ions, dtype=dtype, device=device)
    for s in range(0, shifts_t.shape[0], chunk):
        s_chunk = shifts_t[s:s + chunk]
        # r_vec[b, i, j] = R_j + s_b . h - R_i
        disp = (coords[None, None, :, :]
                + (s_chunk @ box_vecs)[:, None, None, :]
                - coords[None, :, None, :])
        r = safe_sqrt(torch.sum(disp * disp, dim=-1))
        valid = (r < Rc) & (r > 1e-12)
        r_safe = torch.where(valid, r, 1.0)
        pair_E = torch.where(valid, zz * torch.special.erfc(r_safe / Rd)
                             / r_safe, 0.0)
        E_local = E_local + 0.5 * torch.sum(pair_E)
        # neighbour-charge accumulation: Q_i += sum_{j, b} Z_j [valid]
        Qi = Qi + torch.sum(torch.where(valid, charges[None, None, :], 0.0),
                            dim=(0, 2))

    rho = torch.sum(charges) / volume(box_vecs)
    aux = (0.75 / np.pi) * Qi / rho
    Ra = torch.sign(aux) * torch.abs(aux) ** (1.0 / 3.0)
    sqrt_pi = float(np.sqrt(np.pi))
    E_corr = torch.sum(
        -np.pi * charges * rho * Ra**2
        + np.pi * charges * rho * (Ra**2 - 0.5 * Rd * Rd)
        * torch.special.erf(Ra / Rd)
        + sqrt_pi * charges * rho * Ra * Rd * torch.exp(-Ra**2 / Rd**2)
        - charges**2 / sqrt_pi / Rd)
    return E_local + E_corr
