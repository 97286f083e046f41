"""Drop-in import surface under the reference's module name
``elastic_tools``: the EOS fit and the polycrystalline elastic averages,
re-exported from :mod:`professad_tpu_torch.utils.elastic`."""

from .utils.elastic import (fit_eos, voigt_moduli, reuss_moduli,
                            shear_average, poissons_ratio, youngs_modulus)

__all__ = [
    "fit_eos", "voigt_moduli", "reuss_moduli", "shear_average",
    "poissons_ratio", "youngs_modulus",
]
