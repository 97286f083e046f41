"""Drop-in import surface under the reference's module name
``functional_tools``: the autodiff utilities, grid derivatives, density
descriptors, interpolation and the field-dependent convolution,
re-exported from :mod:`professad_tpu_torch.ops`."""

from .ops.autodiff import (get_functional_derivative, get_inv_G, get_stress,
                           get_pressure)
from .ops.grid import (wavevecs, grad_i, grad_dot_grad, laplacian,
                       reduced_gradient, reduced_gradient_squared,
                       reduced_laplacian)
from .ops.interp import interpolate, interpolate_kernel
from .ops.fieldconv import (field_dependent_convolution,
                            field_dependent_convolution_naive, xi_ladder)

__all__ = [
    "get_functional_derivative", "get_inv_G", "get_stress", "get_pressure",
    "wavevecs", "grad_i", "grad_dot_grad", "laplacian",
    "reduced_gradient", "reduced_gradient_squared", "reduced_laplacian",
    "interpolate", "interpolate_kernel",
    "field_dependent_convolution", "field_dependent_convolution_naive",
    "xi_ladder",
]
