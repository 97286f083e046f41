"""One pass over the port's distributed paths on a ("batch", "grid") mesh:
the counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``.

    torchrun --nproc-per-node N -m professad_tpu_torch.parallel.dryrun
    python -m professad_tpu_torch.parallel.dryrun --cpu N    # gloo ranks

Every rank runs the same steps on the primitive fcc Al cell (WT + PBE,
f64): with ``batch = 2`` where the world size is even, each batch row
solves its own system (a start density scaled by 1 + 0.01 i) on its grid
group, a few L-BFGS then TPGD iterations of the autograd gradient; the
hand-fused WT + PBE pencil solve and a generic term set's; forces, stress
and pressure with the mesh attached; and the bulk modulus at 8^3 on the
mesh against the serial getter (1e-7).  Rank 0 prints one line per step.
``--cpu N`` starts N gloo ranks itself; under ``torchrun`` the default
device is ``cuda:{LOCAL_RANK}`` with NCCL.
"""

import argparse
import os
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def fcc_al(shape, device):
    from .. import System
    from ..models import (IonIon, IonElectron, Hartree, WangTeter,
                          PerdewBurkeErnzerhof)
    box = 4.050 * np.array([[0.5, 0.5, 0.0], [0.0, 0.5, 0.5],
                            [0.5, 0.0, 0.5]])
    pot = os.path.join(ROOT, "tests", "potentials", "al.gga.recpot")
    return System(box, shape, [["Al", pot, np.zeros((1, 3))]],
                  [IonIon, IonElectron, Hartree, WangTeter,
                   PerdewBurkeErnzerhof], units="a", coord_type="fractional",
                  device=device)


def run(device):
    """The dry run on the started process group; every rank calls it."""
    import torch.distributed as dist
    from . import make_mesh, grid_group, gather_grid
    from .pfft import pencil_tpgd_minimize
    from ..models import IonElectron, Hartree, vWGTF1, PerdewBurkeErnzerhof

    world, rank = dist.get_world_size(), dist.get_rank()

    def say(msg):
        if rank == 0:
            print(f"dryrun: {msg}", flush=True)

    batch = 2 if world % 2 == 0 else 1
    mesh = make_mesh(batch=batch)
    _, n_grid, _ = grid_group(mesh)
    shape = (4 * n_grid, 8, 8)
    s = fcc_al(shape, device)
    box, v_ext, N = s._box_vecs, s._v_ext, float(s._N_elec)
    M = s._exact_precond_kernel(box, N)
    chi0 = torch.sqrt(s._den).reshape(-1)

    # the batch rows: one system each, its grid group solving it
    row = mesh["batch"].get_local_rank()
    terms = s._terms
    st, _, _ = pencil_tpgd_minimize(
        mesh, shape, box, v_ext, N, chi0 * (1.0 + 0.01 * row), None,
        lr=0.1, ntol=1e-7, max_iter=3, skip_iters=1, method="LBFGS",
        terms=terms)
    st, _, _ = pencil_tpgd_minimize(
        mesh, shape, box, v_ext, N,
        gather_grid(st.x.reshape(-1), mesh), M, lr=1.0, ntol=1e-7,
        max_iter=2, terms=terms)
    f = torch.tensor([float(st.f)], dtype=torch.float64, device=device)
    fs = [torch.empty_like(f) for _ in range(batch)]
    dist.all_gather(fs, f, group=mesh["batch"].get_group())
    fs = [float(x) for x in fs]
    assert np.all(np.isfinite(fs)), "non-finite energies"
    say(f"mesh {tuple(mesh.mesh.shape)} (batch, grid), grid {shape}: "
        f"batched L-BFGS + TPGD step OK, E per row {fs} Ha")

    st, n_it, _ = pencil_tpgd_minimize(mesh, shape, box, v_ext, N, chi0, M,
                                       lr=1.0, ntol=1e-7, max_iter=8)
    assert np.isfinite(float(st.f)), "non-finite pencil-solve energy"
    say(f"hand-fused WT + PBE pencil solve OK ({n_it} iterations, "
        f"E={float(st.f):.6f} Ha)")
    generic = [IonElectron, Hartree, vWGTF1, PerdewBurkeErnzerhof]
    st_g, n_it_g, _ = pencil_tpgd_minimize(
        mesh, shape, box, v_ext, N, chi0, M, lr=1.0, ntol=1e-7, max_iter=6,
        terms=generic, analytic=True)
    assert np.isfinite(float(st_g.f)), "non-finite generic pencil energy"
    say(f"generic term set OK ({n_it_g} iterations, "
        f"E={float(st_g.f):.6f} Ha)")

    s._set_den_from_chi(gather_grid(st.x.reshape(shape[0] // n_grid,
                                                 *shape[1:]), mesh))
    s.set_mesh(mesh)
    F, sig = s.forces(), s.stress()
    assert bool(torch.isfinite(F).all() and torch.isfinite(sig).all())
    say(f"forces / stress OK (max|F|={float(F.abs().max()):.3e} Ha/b, "
        f"P={-float(torch.trace(sig)) / 3:.3e} Ha/b^3)")
    P = s.pressure()
    assert np.isfinite(P), "non-finite pressure"
    say(f"pressure OK (P={P:.3e} Ha/b^3)")

    grid_mesh = make_mesh()   # every rank on the grid axis
    s8 = fcc_al((8, 8, 8), device)
    s8.optimize_density(ntol=1e-10, jit_loop=True, precondition=True,
                        n_step_size=1.0, n_method="TPGD", skip_iters=2,
                        analytic=True)
    K_ser = s8.bulk_modulus()
    if 8 % grid_group(grid_mesh)[1] == 0:
        s8.set_mesh(grid_mesh)
        K_par = s8.bulk_modulus()
        rel = abs(K_par - K_ser) / abs(K_ser)
        assert rel < 1e-7, (K_par, K_ser)
        say(f"bulk modulus OK (K={K_par:.6e} Ha/b^3, against the serial "
            f"getter {rel:.2e})")


def _spawned(rank, n, rdv):
    from . import init_process_group
    import torch.distributed as dist
    torch.set_num_threads(1)
    device = init_process_group(rank, n, "file://" + rdv, device="cpu")
    try:
        run(device)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", type=int, default=0, metavar="N",
                    help="start N gloo ranks on the CPU (no torchrun)")
    args = ap.parse_args(argv)
    if args.cpu:
        import torch.multiprocessing as mp
        with tempfile.TemporaryDirectory() as tmp:
            mp.start_processes(_spawned, args=(args.cpu,
                                               os.path.join(tmp, "rdv")),
                               nprocs=args.cpu, start_method="spawn")
        return 0
    from . import init_process_group
    import torch.distributed as dist
    device = init_process_group()
    try:
        run(device)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
