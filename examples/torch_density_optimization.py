"""Density optimization walkthrough with the PyTorch/CUDA port (the port's
version of examples/density_optimization.py).

Builds fcc aluminium with the Wang-Teter kinetic functional and PBE XC, and
minimizes the energy over the electron density four ways:

1. the host loop with verbose iteration tables (L-BFGS, autograd gradient);
2. ``jit_loop=True``: in the JAX package the whole optimization is one
   ``lax.while_loop`` program; in the port it is a host loop too, which
   reads one scalar per check of the stopping rule (L-BFGS in blocks of
   6 iterations) and keeps everything else on the device;
3. preconditioned TPGD: BB2 steps in the metric of the exact
   uniform-density preconditioner, applied by the hand-written
   spectral-convolution kernel on the card;
4. the same with the fused analytic potentials: E and dE/dn in one
   forward sweep, no autograd graph.  This is the port's main path; the
   kernel also computes the WT kernel convolution and the vW Laplacian.

Every path lands on the same ground state.  The times printed include each
path's first calls (cuFFT plans, the kernel build on the first card call).

Run:  python examples/torch_density_optimization.py [--device cpu]
(the default device is the first CUDA card).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))  # repo-root run

import numpy as np

from professad_tpu_torch.system import System
from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                        WangTeter, PerdewBurkeErnzerhof)
from professad_tpu_torch.ops import spectral_conv

POT = os.path.join(os.path.dirname(__file__), "..", "tests", "potentials",
                   "al.gga.recpot")
BOX = 4.050 * np.array([[0.5, 0.5, 0.0],
                        [0.0, 0.5, 0.5],
                        [0.5, 0.0, 0.5]])
TPGD = dict(n_method="TPGD", n_step_size=1.0, precondition=True,
            skip_iters=2)


def _timed(system, label, verbose, **kwargs):
    """Optimize from the uniform density; the path's energy, iterations,
    seconds and spectral-convolution kernel launches."""
    system.initialize_density()
    before = spectral_conv.launches
    t0 = time.perf_counter()
    n_it, conv = system.optimize_density(ntol=1e-7, n_verbose=verbose,
                                         **kwargs)
    E = system.energy("eV")       # reads the energy: waits for the device
    t = time.perf_counter() - t0
    launches = spectral_conv.launches - before
    print(f"{label:16s}: {E:.10f} eV, {n_it} iterations, {t:.2f} s, "
          f"{launches} kernel launches")
    return dict(E=E, n_it=n_it, conv=conv, t=t, launches=launches)


def main(device=None, ecut=1200.0, verbose=True):
    """Run the four paths; returns their numbers (energies in eV)."""
    shape = System.ecut2shape(ecut, BOX)  # plane-wave cutoff in eV
    print(f"grid shape from {ecut:g} eV cutoff: {shape}")
    ions = [["Al", POT, np.zeros((1, 3))]]
    terms = [IonIon, IonElectron, Hartree, WangTeter, PerdewBurkeErnzerhof]
    system = System(BOX, shape, ions, terms, units="a",
                    coord_type="fractional", device=device)
    out = dict(shape=shape)

    # 1. host loop with the reference's verbose table
    out["host"] = _timed(system, "host loop", verbose)
    out["mu"] = system.chemical_potential()
    out["euler"] = system.check_density_convergence("euler")
    print(f"chemical pot.   : {out['mu']:.6f} Ha")
    print(f"max |mu - dE/dn|: {out['euler']:.3e}")

    # 2. the JAX package's whole-optimization path, a host loop here
    out["jit_loop"] = _timed(system, "jit_loop", verbose, jit_loop=True)

    # 3. exact-preconditioned TPGD with near-Newton steps
    out["tpgd"] = _timed(system, "precond. TPGD", verbose, jit_loop=True,
                         **TPGD)

    # 4. the production gradient: fused analytic potentials
    out["analytic"] = _timed(system, "analytic TPGD", verbose,
                             jit_loop=True, analytic=True, **TPGD)
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda:0)")
    main(parser.parse_args().device)
