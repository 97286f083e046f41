"""Drop-in import surface under the reference's module name ``ion_utils``:
recpot reading and interpolation, the exact and PME structure factors, the
lattice sum and the real-space ion-ion sum, re-exported from
:mod:`professad_tpu_torch.models.ions`."""

from .models.ions import (get_ion_charge, interpolate_recpot, lattice_sum,
                          structure_factor, cardinal_b_spline_values,
                          exponential_spline_b, structure_factor_spline,
                          ion_interaction_sum, neighbor_shifts, read_recpot)

__all__ = [
    "get_ion_charge", "interpolate_recpot", "lattice_sum",
    "structure_factor", "cardinal_b_spline_values", "exponential_spline_b",
    "structure_factor_spline", "ion_interaction_sum", "neighbor_shifts",
    "read_recpot",
]
