"""Shared set-up of the port's EOS tests: the 1-atom fcc Al cell of
tests/test_robustness.py (WT + PBE) in both packages, and a recorder of
the (volume, energy) points each package's eos_fit hands to its fit."""

import numpy as np
import torch

from paths import pot

BOX = 4.05 * np.array([[0.5, 0.5, 0.0], [0.0, 0.5, 0.5], [0.5, 0.0, 0.5]])
SHAPE = (10, 10, 10)


def jax_system(shape=SHAPE):
    import jax.numpy as jnp
    from professad_tpu.system import System
    from professad_tpu.models import (IonIon, IonElectron, Hartree,
                                      WangTeter, PerdewBurkeErnzerhof)
    terms = [IonIon, IonElectron, Hartree, WangTeter, PerdewBurkeErnzerhof]
    return System(jnp.asarray(BOX), shape,
                  [["Al", pot("al.gga.recpot"), jnp.zeros((1, 3))]], terms,
                  units="a", coord_type="fractional")


def torch_system(shape=SHAPE, terms=None, dtype=torch.float64):
    from professad_tpu_torch import System
    from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                            WangTeter, PerdewBurkeErnzerhof)
    if terms is None:
        terms = [IonIon, IonElectron, Hartree, WangTeter,
                 PerdewBurkeErnzerhof]
    return System(BOX, shape, [["Al", pot("al.gga.recpot"),
                                np.zeros((1, 3))]], terms, units="a",
                  coord_type="fractional", device="cpu", dtype=dtype)


def eos_points(monkeypatch, module, system, **kw):
    """system.eos_fit(**kw) with the (volumes, energies) its fit receives:
    returns (params, volumes, energies)."""
    seen = {}
    fit = module.fit_eos

    def record(volumes, energies, *args):
        seen["v"], seen["e"] = np.asarray(volumes), np.asarray(energies)
        return fit(volumes, energies, *args)

    monkeypatch.setattr(module, "fit_eos", record)
    params, _ = system.eos_fit(**kw)
    return np.asarray(params), seen["v"], seen["e"]
