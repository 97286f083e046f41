"""Drop-in import surface under the reference's module name
``functionals``: every public name of ``professad_tpu.functionals``,
re-exported from this package's :mod:`professad_tpu_torch.models`.

Migrating a script from the JAX package is a package-name substitution::

    from professad_tpu.functionals import IonIon, WangTeter
    from professad_tpu_torch.functionals import IonIon, WangTeter
"""

from .models import (
    IonIon, IonElectron, Hartree, hartree_potential,
    KineticFunctional,
    ThomasFermi, Weizsaecker, vWGTF1, vWGTF2, LuoKarasievTrickey,
    PauliGaussian, YukawaGGA,
    G_inv_lind_analytical, G_inv_lind, G_inv_lindhard, non_local_KEF,
    WangTeter, Perrot, SmargiassiMadden, WangGovindCarter98,
    WangTeterStyleFunctional, WangGovindCarter99, FoleyMadden,
    G_inv_gap, KGAP, HuangCarter, RevisedHuangCarter, MiGenovaPavanello,
    XuWangMa,
    lda_exchange, perdew_zunger_correlation, perdew_wang_correlation,
    chachiyo_correlation, PerdewZunger, PerdewWang, Chachiyo,
    pbe_exchange, pbe_correlation, PerdewBurkeErnzerhof,
    NeuralNetworkFunctional,
)

__all__ = [
    "IonIon", "IonElectron", "Hartree", "hartree_potential",
    "KineticFunctional", "ThomasFermi", "Weizsaecker", "vWGTF1", "vWGTF2",
    "LuoKarasievTrickey", "PauliGaussian", "YukawaGGA",
    "G_inv_lind_analytical", "G_inv_lind", "G_inv_lindhard", "non_local_KEF",
    "WangTeter", "Perrot", "SmargiassiMadden", "WangGovindCarter98",
    "WangTeterStyleFunctional", "WangGovindCarter99", "FoleyMadden",
    "G_inv_gap", "KGAP", "HuangCarter", "RevisedHuangCarter",
    "MiGenovaPavanello", "XuWangMa",
    "lda_exchange", "perdew_zunger_correlation", "perdew_wang_correlation",
    "chachiyo_correlation", "PerdewZunger", "PerdewWang", "Chachiyo",
    "pbe_exchange", "pbe_correlation", "PerdewBurkeErnzerhof",
    "NeuralNetworkFunctional",
]
