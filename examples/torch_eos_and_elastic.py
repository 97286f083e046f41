"""Equation of state and elastic properties with the PyTorch/CUDA port
(the port's version of examples/eos_and_elastic.py).

* ``eos_fit``: Birch-Murnaghan fit over a density-optimized volume scan;
  ``batched=True`` solves every volume at once, as the lanes of one
  ``torch.func.vmap``-ped solve.
* ``bulk_modulus``: K = V d2E/dV2 through the ground state (implicit
  differentiation; no finite differences, no refitting).
* ``elastic_constants``: the 6x6 Voigt matrix through the ground state.

Run:  python examples/torch_eos_and_elastic.py [--device cpu]
(the default device is the first CUDA card).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))  # repo-root run

import numpy as np

from professad_tpu_torch.system import System
from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                        WangTeter, PerdewBurkeErnzerhof)
from professad_tpu_torch.utils.crystal import get_cell
from professad_tpu_torch.utils.elastic import voigt_moduli

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default=None,
                    help="torch device (default: cuda:0)")
device = parser.parse_args().device

POT = os.path.join(os.path.dirname(__file__), "..", "tests", "potentials",
                   "al.gga.recpot")

box_vecs, frac = get_cell("fcc", vol_per_atom=16.8, device=device)  # A
ions = [["Al", POT, frac]]
terms = [IonIon, IonElectron, Hartree, WangTeter, PerdewBurkeErnzerhof]
system = System(box_vecs, (20, 20, 20), ions, terms, units="a",
                coord_type="fractional", device=device)

# Birch-Murnaghan EOS over a +-5% volume scan, all volumes at once
params, err = system.eos_fit(f=0.05, N=9, eos="bm", verbose=True,
                             batched=True)
K0, K0p, E0, V0 = params
print(f"\nEOS fit: K0 = {K0:.3f} GPa, K0' = {K0p:.4f}, "
      f"E0 = {E0:.4f} eV/atom, V0 = {V0:.3f} A^3/atom")

# bulk modulus at the current volume from implicit differentiation
system.optimize_density(ntol=1e-9)
K_ad = system.bulk_modulus("GPa")
print(f"bulk modulus (autodiff through the ground state): {K_ad:.3f} GPa")

# elastic constants (Birch coefficients) and the Voigt-average bulk modulus
C = system.elastic_constants("GPa").cpu().numpy()
print("elastic constants [GPa]:")
print(np.array2string(C, precision=2, suppress_small=True))
Kv, Gv = voigt_moduli(C)
print(f"Voigt: K = {float(Kv):.3f} GPa (vs autodiff K = {K_ad:.3f}), "
      f"G = {float(Gv):.3f} GPa")
