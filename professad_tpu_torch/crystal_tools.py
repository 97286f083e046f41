"""Drop-in import surface under the reference's module name
``crystal_tools``: the crystal cell generators, re-exported from
:mod:`professad_tpu_torch.utils.crystal`."""

from .utils.crystal import (get_cell, simple_cubic, body_centered_cubic,
                            face_centered_cubic, diamond_cubic,
                            hexagonal_close_packed)

__all__ = [
    "get_cell", "simple_cubic", "body_centered_cubic",
    "face_centered_cubic", "diamond_cubic", "hexagonal_close_packed",
]
