from . import constants  # noqa: F401
from .naming import term_name  # noqa: F401
from .device import resolve_device  # noqa: F401
from .crystal import get_cell  # noqa: F401
from .elastic import (fit_eos, voigt_moduli, reuss_moduli,  # noqa: F401
                      shear_average, poissons_ratio, youngs_modulus)
from .profiling import trace, annotate, StepTimer  # noqa: F401
