"""Energy functionals ported so far: the density-optimization term set
(IonIon, IonElectron, Hartree, ThomasFermi, Weizsaecker, WangTeter, PBE)."""

from .interaction import IonIon, IonElectron, Hartree, hartree_potential
from .kinetic_local import ThomasFermi, Weizsaecker
from .kinetic_nonlocal import (G_inv_lind_analytical, G_inv_lind,
                               G_inv_lindhard, non_local_KEF, WangTeter)
from .xc import pbe_exchange, pbe_correlation, PerdewBurkeErnzerhof
from . import ions  # noqa: F401

__all__ = ["IonIon", "IonElectron", "Hartree", "hartree_potential",
           "ThomasFermi", "Weizsaecker", "G_inv_lind_analytical",
           "G_inv_lind", "G_inv_lindhard", "non_local_KEF", "WangTeter",
           "pbe_exchange", "pbe_correlation", "PerdewBurkeErnzerhof"]
