#!/usr/bin/env python3
"""Where the float32 EOS scan's scatter comes from: the solver's own
energies or the end-point densities.

    python3 eos_noise.py [--device cpu] [--n 128] [--runs 3]

For the main path's cell (4-atom cubic fcc Al, WT + PBE) at n^3 and 9
volumes over +-5%, runs the float32 scan ``--runs`` times (chi scaled by
1 + k 1e-7, k = 0, 1, ...), each as the lane-batched solve and as the
serial solve of each volume (TPGD, fused gradient, lr 1.0, ntol 1e-7), and
prints per volume, in ueV/atom above the float64 minimum: the solver's own
float32 energy (what the JAX package's batched scan fits) and the float64
energy of the float32 end point (what the port's scan fits), with the
Birch-Murnaghan K0 and V0 fitted from each.  Needs a CUDA device unless
``--device cpu``.
"""

import argparse

import numpy as np
import torch

from chip_smoke import build_bench_system, _eos_fit_points
from professad_tpu_torch.ops import solvers
from professad_tpu_torch.ops.grid import spectral_convolution
from professad_tpu_torch.utils.constants import EV_PER_HA


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    if args.device is None and not torch.cuda.is_available():
        raise SystemExit("eos_noise: no CUDA device (pass --device cpu)")
    dev = torch.device(args.device or "cuda")
    n = args.n
    s = build_bench_system((n, n, n), torch.float32, dev)
    vs = s.volume("a3") * np.linspace(0.95, 1.05, 9)
    norm = (s.lattice_vectors("a") / s.volume("a3") ** (1 / 3)).cpu().numpy()
    box64, vext64, chi64, E_ions = s._eos_points(vs, norm)
    f64 = np.array(s._eos_solve_fn("TPGD", 1.0, 1e-10, 3, 1000, True,
                                   dtype=torch.float64)(
        chi64, box64, vext64)[0])
    box, vext, chi = (t.to(torch.float32) for t in (box64, vext64, chi64))
    N = float(s.electron_count())
    shape = tuple(chi.shape[1:])

    def vg(x, b, v, M):
        return s._chi_value_and_grad_analytic(x, b, v, N)

    def aH0(q, b, v, M):
        return spectral_convolution(M, q.reshape(shape), shape).reshape(
            q.shape)

    M = torch.func.vmap(lambda b: s._exact_precond_kernel(b, N))(box)
    kw = dict(lr=1.0, ntol=1e-7, conv_count=3, max_iter=1000,
              f_scale=EV_PER_HA, skip_iters=2)
    per_atom = s.eV_per_Ha / s.ion_count() * 1e6
    p = _eos_fit_points(s, vs, f64, E_ions)
    print(f"{n}^3 on {dev}: f64 minimum K0 {p[0]:.6f} GPa, V0 {p[3]:.9f}")
    for k in range(args.runs):
        c = chi * (1 + k * 1e-7)
        st, _, _ = solvers.tpgd_minimize_lanes(
            vg, c, lanes=(box, vext, M), apply_H0=aH0, **kw)
        ends = {"batched": (st.f.tolist(), st.x)}
        fs, xs = [], []
        for b in range(9):
            stb, _, _ = solvers.tpgd_minimize(
                lambda x: vg(x, box[b], vext[b], M[b]), c[b],
                apply_H0=lambda q: aH0(q, box[b], vext[b], M[b]), **kw)
            fs.append(float(stb.f))
            xs.append(stb.x)
        ends["serial"] = (fs, torch.stack(xs))
        for tag, (f32, x) in ends.items():
            e64 = [s._eos_energy(x[b], box64[b], vext64[b])
                   for b in range(9)]
            for name, e in (("solver f32 energy", f32),
                            ("f64 energy at the end point", e64)):
                p = _eos_fit_points(s, vs, e, E_ions)
                d = (np.asarray(e) - f64) * per_atom
                print(f"run {k} {tag:7s} {name:27s}: K0 {p[0]:.6f} GPa, V0 "
                      f"{p[3]:.9f}; above the f64 minimum (ueV/atom) "
                      + " ".join(f"{v:.4f}" for v in d))


if __name__ == "__main__":
    main()
