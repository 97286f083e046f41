"""Crystal structure generators (lattice vectors and ionic coordinates).

PyTorch port of ``professad_tpu/utils/crystal.py``.  The cells are built in
float64 numpy, with the JAX package's arithmetic, and returned as float64
tensors on ``device`` (``None`` means ``cuda:0``, as for every entry point
of the port; pass ``device="cpu"`` for the CPU).
"""

import numpy as np
import torch

from .device import resolve_device

__all__ = ["get_cell", "simple_cubic", "body_centered_cubic",
           "face_centered_cubic", "diamond_cubic", "hexagonal_close_packed"]

_FCC_PRIM = [[0.0, 0.5, 0.5], [0.5, 0.0, 0.5], [0.5, 0.5, 0.0]]


def _out(lv, fc, device):
    dev = resolve_device(device)
    return (torch.tensor(lv, dtype=torch.float64, device=dev),
            torch.tensor(fc, dtype=torch.float64, device=dev))


def _cell_type(cell_type):
    if cell_type not in ("primitive", "conventional"):
        raise ValueError("cell_type must be 'primitive' or 'conventional'")
    return cell_type == "primitive"


def get_cell(crystal, vol_per_atom, c_over_a=np.sqrt(8.0 / 3.0),
             coord_type="fractional", device=None):
    """Lattice vectors (rows) and ion coordinates of a simple crystal.

    crystal: 'sc', 'bcc', 'bcc-c', 'fcc', 'fcc-c', 'dc', 'dc-c', 'hcp'
    (the '-c' forms are the conventional cubic cells); coord_type
    'fractional' or 'cartesian'."""
    cells = {
        "sc": lambda d: simple_cubic(vol_per_atom, device=d),
        "bcc": lambda d: body_centered_cubic(vol_per_atom, "primitive", d),
        "bcc-c": lambda d: body_centered_cubic(vol_per_atom, "conventional",
                                               d),
        "fcc": lambda d: face_centered_cubic(vol_per_atom, "primitive", d),
        "fcc-c": lambda d: face_centered_cubic(vol_per_atom, "conventional",
                                               d),
        "dc": lambda d: diamond_cubic(vol_per_atom, "primitive", d),
        "dc-c": lambda d: diamond_cubic(vol_per_atom, "conventional", d),
        "hcp": lambda d: hexagonal_close_packed(vol_per_atom, c_over_a, d),
    }
    if crystal not in cells:
        raise ValueError(f"'crystal' argument '{crystal}' not recognized")
    if coord_type not in ("fractional", "cartesian"):
        raise ValueError("coord_type must be 'fractional' or 'cartesian'")
    lv, fc = cells[crystal](device)
    return (lv, fc) if coord_type == "fractional" else (lv, fc @ lv)


def simple_cubic(vol_per_atom, device=None):
    a = vol_per_atom ** (1.0 / 3.0)
    return _out(a * np.eye(3), np.zeros((1, 3)), device)


def body_centered_cubic(vol_per_atom, cell_type="conventional",
                        device=None):
    a = (2.0 * vol_per_atom) ** (1.0 / 3.0)
    if _cell_type(cell_type):
        lv = a * np.asarray([[-0.5, 0.5, 0.5], [0.5, -0.5, 0.5],
                             [0.5, 0.5, -0.5]])
        fc = np.zeros((1, 3))
    else:
        lv = a * np.eye(3)
        fc = np.asarray([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]])
    return _out(lv, fc, device)


def face_centered_cubic(vol_per_atom, cell_type="primitive", device=None):
    a = (4.0 * vol_per_atom) ** (1.0 / 3.0)
    if _cell_type(cell_type):
        lv = a * np.asarray(_FCC_PRIM)
        fc = np.zeros((1, 3))
    else:
        lv = a * np.eye(3)
        fc = np.asarray([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0],
                         [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]])
    return _out(lv, fc, device)


def diamond_cubic(vol_per_atom, cell_type="conventional", device=None):
    a = (8.0 * vol_per_atom) ** (1.0 / 3.0)
    if _cell_type(cell_type):
        lv = a * np.asarray(_FCC_PRIM)
        fc = np.asarray([[0.0, 0.0, 0.0], [0.25, 0.25, 0.25]])
    else:
        lv = a * np.eye(3)
        fc = np.asarray([[0.00, 0.00, 0.00], [0.50, 0.50, 0.00],
                         [0.50, 0.00, 0.50], [0.00, 0.50, 0.50],
                         [0.25, 0.25, 0.25], [0.25, 0.75, 0.75],
                         [0.75, 0.75, 0.25], [0.75, 0.25, 0.75]])
    return _out(lv, fc, device)


def hexagonal_close_packed(vol_per_atom, c_over_a=1.633, device=None):
    a = ((2.0 * vol_per_atom) / (np.sqrt(3.0) / 2.0 * c_over_a)) \
        ** (1.0 / 3.0)
    lv = a * np.asarray([[1.0, 0.0, 0.0],
                         [-0.5, np.sqrt(3.0) / 2.0, 0.0],
                         [0.0, 0.0, c_over_a]])
    fc = np.asarray([[1.0 / 3.0, 2.0 / 3.0, 0.75],
                     [2.0 / 3.0, 1.0 / 3.0, 0.25]])
    return _out(lv, fc, device)
