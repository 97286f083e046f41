"""Functional-derivative and linear-response autodiff utilities with the
PyTorch/CUDA port (the port's version of examples/autodiff_utils.py).

* delta T / delta n for the Wang-Teter functional on an optimized density,
  compared against the Euler equation mu = dE/dn.
* G^{-1}(eta) of WT from two nested torch.func.grad passes, compared with
  the closed-form Lindhard function.

Run:  python examples/torch_autodiff_utils.py [--device cpu]
(the default device is the first CUDA card).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))  # repo-root run

import numpy as np
import torch

from professad_tpu_torch.system import System
from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                        WangTeter, PerdewBurkeErnzerhof,
                                        G_inv_lindhard)
from professad_tpu_torch.ops.autodiff import (get_functional_derivative,
                                              get_inv_G)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default=None,
                    help="torch device (default: cuda:0)")
device = parser.parse_args().device

POT = os.path.join(os.path.dirname(__file__), "..", "tests", "potentials",
                   "al.gga.recpot")

box_vecs = 4.050 * np.array([[0.5, 0.5, 0.0],
                             [0.0, 0.5, 0.5],
                             [0.5, 0.0, 0.5]])
ions = [["Al", POT, np.zeros((1, 3))]]
terms = [IonIon, IonElectron, Hartree, WangTeter, PerdewBurkeErnzerhof]
system = System(box_vecs, (20, 20, 20), ions, terms, units="a",
                coord_type="fractional", device=device)
system.optimize_density(ntol=1e-8)

# functional derivative (kinetic potential) on the optimized density
den = system.density()
v_T = get_functional_derivative(system.lattice_vectors("b"), den, WangTeter)
print(f"kinetic potential range: [{float(v_T.min()):.4f}, "
      f"{float(v_T.max()):.4f}] Ha")

# at the ground state, dE/dn == mu (constant): check the spread
dEdn = system.functional_derivative("density")
mu = system.chemical_potential()
print(f"Euler residual max |mu - dE/dn| = "
      f"{float((mu - dEdn).abs().max()):.3e} Ha")

# linear response of WT about the uniform gas == Lindhard
dev = system.device()
uniform = torch.ones((41, 41, 41), dtype=torch.float64, device=dev)
box = 8.0 * torch.eye(3, dtype=torch.float64, device=dev)
eta, G_inv_WT = get_inv_G(box, uniform, WangTeter)
_, G_inv_L = G_inv_lindhard(box, uniform)
err = float((G_inv_WT - G_inv_L).abs().max())
print(f"max |G_inv(WT) - G_inv(Lindhard)| = {err:.3e}")
