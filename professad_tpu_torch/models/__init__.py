"""Energy functionals, under the JAX package's names."""

from .interaction import IonIon, IonElectron, Hartree, hartree_potential
from .xc import (lda_exchange, perdew_zunger_correlation,
                 perdew_wang_correlation, chachiyo_correlation,
                 PerdewZunger, PerdewWang, Chachiyo,
                 pbe_exchange, pbe_correlation, PerdewBurkeErnzerhof)
from .kinetic_local import (ThomasFermi, Weizsaecker, vWGTF1, vWGTF2,
                            LuoKarasievTrickey, PauliGaussian, YukawaGGA)
from .kinetic_nonlocal import (G_inv_lind_analytical, G_inv_lind,
                               G_inv_lindhard, non_local_KEF, WangTeter,
                               Perrot, SmargiassiMadden, WangGovindCarter98,
                               WangTeterStyleFunctional, WangGovindCarter99,
                               FoleyMadden, G_inv_gap, KGAP, HuangCarter,
                               RevisedHuangCarter, MiGenovaPavanello, XuWangMa)
from .base import KineticFunctional
from .neural import NeuralNetworkFunctional
from . import ions  # noqa: F401

__all__ = ["IonIon", "IonElectron", "Hartree", "hartree_potential",
           "lda_exchange", "perdew_zunger_correlation",
           "perdew_wang_correlation", "chachiyo_correlation",
           "PerdewZunger", "PerdewWang", "Chachiyo",
           "pbe_exchange", "pbe_correlation", "PerdewBurkeErnzerhof",
           "ThomasFermi", "Weizsaecker", "vWGTF1", "vWGTF2",
           "LuoKarasievTrickey", "PauliGaussian", "YukawaGGA",
           "G_inv_lind_analytical", "G_inv_lind", "G_inv_lindhard",
           "non_local_KEF", "WangTeter", "Perrot", "SmargiassiMadden",
           "WangGovindCarter98", "WangTeterStyleFunctional",
           "WangGovindCarter99", "FoleyMadden", "G_inv_gap", "KGAP",
           "HuangCarter", "RevisedHuangCarter", "MiGenovaPavanello",
           "XuWangMa", "KineticFunctional", "NeuralNetworkFunctional"]
