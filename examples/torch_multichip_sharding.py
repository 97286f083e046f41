"""Multi-device density optimization with the PyTorch/CUDA port (the
port's version of examples/multichip_sharding.py).

The 3-D grid is split along its first axis over the "grid" axis of a
("batch", "grid") device mesh; every FFT is a pencil transform with one
all_to_all, every mean a psum (``professad_tpu_torch.parallel``).  The port
runs SPMD, one process per device:

  torchrun --nproc-per-node 4 examples/torch_multichip_sharding.py
      (NCCL, one card per rank)
  python examples/torch_multichip_sharding.py --cpu 4
      (4 gloo ranks on the CPU, started by the script)

Every rank builds the same System and calls the same methods; rank 0
prints.  The same ground state from one process is printed beside it.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))  # repo-root run

import numpy as np
import torch
import torch.distributed as dist

from professad_tpu_torch.system import System
from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                        WangTeter, PerdewBurkeErnzerhof)
from professad_tpu_torch.parallel import (init_process_group, make_mesh,
                                          grid_group)

POT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                   "tests", "potentials", "al.gga.recpot")
FRAC = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5],
                 [0.0, 0.5, 0.5]])
SOLVE = dict(ntol=1e-9, jit_loop=True, n_method="TPGD", n_step_size=1.0,
             skip_iters=2, analytic=True, precondition=True,
             from_uniform=True)


def run(device):
    mesh = make_mesh()
    _, n_grid, _ = grid_group(mesh)
    n = 8 * n_grid                      # axes 0 and 1 divide by the mesh
    system = System(4.050 * np.eye(3), (n, n, n), [["Al", POT, FRAC]],
                    [IonIon, IonElectron, Hartree, WangTeter,
                     PerdewBurkeErnzerhof], units="a",
                    coord_type="fractional", device=device)
    n_it, conv = system.optimize_density(mesh=mesh, **SOLVE)
    E = system.energy("eV")
    F = system.forces("eV/a")           # distributed: the mesh is attached
    P = system.pressure("GPa")
    system.set_mesh(None)               # the same state, one process
    n_ser, _ = system.optimize_density(**SOLVE)
    if dist.get_rank() == 0:
        print(f"mesh {tuple(mesh.mesh.shape)} (batch, grid), grid {n}^3: "
              f"E = {E:.8f} eV in {n_it} iterations (converged {conv}); "
              f"max |F| = {float(F.abs().max()):.2e} eV/A, P = {P:.6f} GPa")
        print(f"one process: E = {system.energy('eV'):.8f} eV in {n_ser} "
              f"iterations")


def spawned(rank, n, rdv):
    torch.set_num_threads(1)
    run(init_process_group(rank, n, "file://" + rdv, device="cpu"))
    dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", type=int, default=0, metavar="N",
                    help="start N gloo ranks on the CPU (no torchrun)")
    args = ap.parse_args()
    if args.cpu:
        import torch.multiprocessing as mp
        with tempfile.TemporaryDirectory() as tmp:
            mp.start_processes(spawned, args=(args.cpu,
                                              os.path.join(tmp, "rdv")),
                               nprocs=args.cpu, start_method="spawn")
        return
    run(init_process_group())           # torchrun: NCCL, cuda:{LOCAL_RANK}
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
