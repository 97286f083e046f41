#!/usr/bin/env python3
"""How far the f32 main path's iteration count moves with rounding, for
the serial path and the mesh path on one rank.

    python3 mesh_scatter.py [--n 128] [--eps 0 1e-7 -1e-7 2e-7 -2e-7 3e-7]
    python3 mesh_scatter.py --cpu --n 32      # gloo on the CPU

The main path's configuration (4-atom cubic fcc Al, WT + PBE, f32, TPGD
with the fused gradient, preconditioned, to |dE| < 1e-7 eV three times in
a row) from a start density scaled by 1 + eps, once serially (on the card:
through the spectral-convolution kernel) and once through
``optimize_density(mesh=make_mesh(1))`` on an NCCL (or gloo) group of
world size 1 (the pencil path).  Prints, per eps, both iteration counts
and energies; ``chip_smoke.py`` [mesh] (a) holds the unperturbed counts
within 2 of each other.
"""

import argparse
import os
import tempfile

import torch

import chip_smoke as cs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--eps", type=float, nargs="+",
                    default=[0.0, 1e-7, -1e-7, 2e-7, -2e-7, 3e-7])
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    from professad_tpu_torch.ops import solvers
    from professad_tpu_torch.parallel import init_process_group, make_mesh
    dev = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    if not args.cpu:
        print(cs.card_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        init_process_group(0, 1, "file://" + os.path.join(tmp, "rdv"),
                           device=dev)
        try:
            mesh = make_mesh(1)
            shape = (args.n,) * 3
            serial = cs.build_bench_system(shape, torch.float32, dev)
            meshed = cs.build_bench_system(shape, torch.float32, dev)
            minimize = solvers.tpgd_minimize
            for eps in args.eps:
                def scaled(vg, x0, *a, eps=eps, **k):
                    return minimize(vg, x0 * (1 + eps), *a, **k)
                solvers.tpgd_minimize = scaled
                n1, _ = cs.optimize(serial)
                n2, _ = meshed.optimize_density(mesh=mesh, **cs.MESH_SOLVE)
                print(f"{args.n}^3 f32, start x (1 + {eps:g}): serial "
                      f"{n1} iterations, E {serial.energy('eV'):.9f} eV; "
                      f"mesh {n2} iterations, E {meshed.energy('eV'):.9f} "
                      f"eV", flush=True)
            solvers.tpgd_minimize = minimize
        finally:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
