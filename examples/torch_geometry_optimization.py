"""Geometry optimization with the PyTorch/CUDA port (the port's version of
examples/geometry_optimization.py).

* Conventional relaxation: perturb a bcc-Li cell and ionic positions, then
  relax both back with autodiff forces and stresses driving L-BFGS.
* Parameterized relaxation: relax an hcp cell over (a, c/a) only: a
  symmetry-constrained geometry given as a function of the parameter
  vector, written with torch ops (it is differentiated by autograd).

Each geometry step re-optimizes the density with the default host loop
(L-BFGS, autograd gradient) to ``ntol``.

Run:  python examples/torch_geometry_optimization.py [--device cpu]
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
                                        SmargiassiMadden,
                                        PerdewBurkeErnzerhof)

POT = os.path.join(os.path.dirname(__file__), "..", "tests", "potentials",
                   "li.gga.recpot")
TERMS = [IonIon, IonElectron, Hartree, SmargiassiMadden,
         PerdewBurkeErnzerhof]


def hcp_geometry_b(p):
    """hcp cell (in bohr) as a function of (a, c/a)."""
    a_len, c_over_a = p[0], p[1]
    one, zero = torch.ones_like(a_len), torch.zeros_like(a_len)
    box = a_len * torch.stack([
        torch.stack([one, zero, zero]),
        torch.stack([-0.5 * one, float(np.sqrt(3.0)) / 2.0 * one, zero]),
        c_over_a * torch.stack([zero, zero, one]),
    ])
    frac = torch.tensor([[1 / 3, 2 / 3, 0.75], [2 / 3, 1 / 3, 0.25]],
                        dtype=p.dtype, device=p.device)
    return box, frac


def main(device=None, n=18, hcp_shape=(16, 16, 24), g_maxiter=1000):
    """Run both relaxations (at most ``g_maxiter`` steps each); returns
    their numbers (lengths in A for the bcc cell, in bohr for hcp)."""
    out = {}
    # ---- conventional relaxation of a rattled bcc-Li cell ----------------
    a = 3.48
    box_vecs = a * np.array([[1.00, 0.02, 0.00],
                             [0.00, 1.00, 0.03],
                             [0.01, 0.00, 1.00]])   # sheared cell
    frac = np.array([[0.02, 0.00, 0.01],
                     [0.51, 0.49, 0.52]])           # displaced ions
    system = System(box_vecs, (n, n, n), [["Li", POT, frac]], TERMS,
                    units="a", coord_type="fractional", device=device)

    print("relaxing ions + cell ...")
    ok = system.optimize_geometry(ftol=0.01, stol=0.002, g_verbose=True,
                                  g_maxiter=g_maxiter, ntol=1e-8)
    lattice = system.lattice_vectors("a").cpu().numpy()
    frac = system.fractional_ionic_coordinates().cpu().numpy()
    out["cell"] = dict(
        converged=ok, lattice=lattice,
        frac=frac, max_force=float(system.forces("eV/a").abs().max()),
        max_stress=float(system.stress("eV/a3").abs().max()))
    print(f"converged: {ok}")
    print("final lattice [A]:")
    print(np.array2string(lattice, precision=4))
    print("final fractional coordinates:")
    print(np.array2string(frac, precision=4))

    # ---- parameterized relaxation: hcp over (a, c/a) ---------------------
    print("\nparameterized hcp relaxation over (a, c/a) ...")
    p0 = torch.tensor([6.0, 1.64], dtype=torch.float64)
    box0, frac0 = hcp_geometry_b(p0)
    hcp = System(box0, hcp_shape, [["Li", POT, frac0]], TERMS, units="b",
                 coord_type="fractional", device=device)
    ok, p_opt = hcp.optimize_parameterized_geometry(
        p0, hcp_geometry_b, ftol=None, stol=0.003, g_verbose=True,
        g_maxiter=g_maxiter, ntol=1e-8,
        param_string=lambda p: f"  a={float(p[0]):.4f} c/a={float(p[1]):.4f}")
    out["hcp"] = dict(converged=ok, a=float(p_opt[0]),
                      c_over_a=float(p_opt[1]))
    print(f"converged: {ok}; a = {float(p_opt[0]):.4f} bohr, "
          f"c/a = {float(p_opt[1]):.4f}")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda:0)")
    main(parser.parse_args().device)
