#!/usr/bin/env python3
"""Rehearsals of the non-local functionals: in both packages, the JAX
package (the reference) and the PyTorch port, f64 and f32, on the CPU; and
single runs of chip_smoke's ``nonlocal`` phase on the card.

    JAX_PLATFORMS=cpu python nonlocal_rehearsal.py converge YukawaGGA-yuk4 32
    JAX_PLATFORMS=cpu python nonlocal_rehearsal.py converge KGAP 16 --dtype f64
    JAX_PLATFORMS=cpu python nonlocal_rehearsal.py steps YukawaGGA-yuk4 32 \\
        10 20 40 80 160
    JAX_PLATFORMS=cpu python nonlocal_rehearsal.py steps hc-test 12 8 9 10 60
    python nonlocal_rehearsal.py card YukawaGGA-yuk4 96 --dtype f32

CASE is a name of ``chip_smoke.NONLOCAL_NAMES``, the term (built by
``chip_smoke.nonlocal_term`` from either package) as the kinetic functional
of chip_smoke's ``nonlocal`` runs: the 4-atom cubic fcc Al cell, IonIon +
IonElectron + Hartree + PBE + the term; or ``hc-test``,
``tests/test_potentials.py``'s Huang-Carter end-to-end case (primitive fcc
Al, HC (0.45, 0.51, 1.2)).  N is the grid, N^3.

``converge CASE N``: preconditioned TPGD with the fused potentials from the
uniform start until |dE| < 1e-7 eV three times in a row (at most 1000
iterations, optimize_density's default).  The JAX package runs through
``System._jit_tpgd_full`` on a state cast to the dtype, as
``tests/test_f32_accuracy.py`` does for f32 (its public path has no f32 on
the CPU).  For each run: the iterations, whether it converged, the energy
per atom evaluated directly in f64 at the final density, and the Euler
residual |mu - dE/dn| there (Ha), its maximum and its density-weighted
mean int n |mu - dE/dn| / N, on the ladder the run minimized on
(prepared from the uniform start) and on one prepared from the final
density.  With both dtypes, also the f32 error of the term's fused sweep at
the port's f64 end point in both packages.  ``--continue-f64`` continues
each end point in the port in f64 with a ladder prepared from it (ntol
1e-12, at most 4000 iterations).  Run it when a 128^3 run of the
``nonlocal`` phase does not converge on the card: it tells the port's fault
(the JAX package converges, the port does not) from the functional's.

``card CASE N``: one run of chip_smoke's ``nonlocal`` phase on the card
(``chip_smoke._nonlocal_run``, ``--dtype`` f32 or f64) at any grid; it
imports no JAX.

``steps CASE N K...``: both packages in f64 through the public
``optimize_density(n_maxiter=K)`` (``hc-test``: ntol 1e-9, as its test):
the stored energies and the largest density difference; then, for a
ladder term at the last K, the ladder the port's run prepared from the
start density against one prepared from its final density, and the port's
energy on the first minus its stored (direct) energy.
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
POT = os.path.join(ROOT, "tests", "potentials", "al.gga.recpot")
EV = 27.211386245988
PRIM = 4.05 * np.array([[0.5, 0.5, 0.0], [0.0, 0.5, 0.5], [0.5, 0.0, 0.5]])


def _case(models, case):
    """(cell, fractional ions, terms, kinetic term) of CASE from either
    package's ``models``."""
    from chip_smoke import FCC, nonlocal_term
    if case == "hc-test":
        term = models.HuangCarter((0.45, 0.51, 1.2)).forward
        cell, frac = PRIM, np.zeros((1, 3))
    else:
        term = nonlocal_term(case, models=models)
        cell, frac = 4.05 * np.eye(3), FCC
    return cell, frac, [models.IonIon, models.IonElectron, models.Hartree,
                        term, models.PerdewBurkeErnzerhof], term


def jax_system(case, n):
    import jax.numpy as jnp
    from professad_tpu import models
    from professad_tpu.system import System
    cell, frac, terms, _ = _case(models, case)
    return System(jnp.asarray(cell), (n, n, n),
                  [["Al", POT, jnp.asarray(frac)]], terms, units="a",
                  coord_type="fractional")


def port_system(case, n, dtype="f64"):
    import torch
    from professad_tpu_torch import System, models
    cell, frac, terms, term = _case(models, case)
    s = System(cell, (n, n, n), [["Al", POT, frac]], terms, units="a",
               coord_type="fractional", device="cpu",
               dtype=torch.float32 if dtype == "f32" else torch.float64)
    return s, getattr(term, "__self__", term)


MAXITER = 1000
TPGD = dict(n_method="TPGD", analytic=True, precondition=True,
            n_step_size=1.0, skip_iters=2, jit_loop=True)


def converge_jax(case, n, dtype):
    import jax.numpy as jnp
    s = jax_system(case, n)
    dt = jnp.float32 if dtype == "f32" else jnp.float64
    s._den = s._uniform_density()
    s._prepare_dynamic_kernels()
    aux = s._collect_term_aux()
    N = float(s._N_elec)
    box = s._box_vecs.astype(dt)
    Mk = s._precond_kernel(box, N, aux)
    st, n_it, conv = s._jit_tpgd_full(
        jnp.sqrt(s._den).astype(dt), box, s._v_ext.astype(dt), N, 1.0, 1e-7,
        3, MAXITER, conv_target="dE", skip_iters=2, aux=aux, analytic=True,
        M_kernel=Mk)
    chi = np.asarray(st.x, np.float64).reshape(s._shape)
    return int(n_it), bool(conv), N / (np.mean(chi * chi) * s.volume("b3")) \
        * chi * chi


def converge_port(case, n, dtype):
    s, _ = port_system(case, n, dtype)
    n_it, conv = s.optimize_density(ntol=1e-7, from_uniform=True,
                                    n_maxiter=MAXITER, **TPGD)
    return n_it, conv, s.density().double().numpy()


class Evaluator:
    """The port in f64 at a given density: direct energy per atom and the
    Euler residual on the start ladder and on the density's own."""

    def __init__(self, case, n):
        self.s, self.owner = port_system(case, n)
        self.s._prepare_dynamic_kernels()           # from the uniform start
        self.start = getattr(self.owner, "xi_sparse", None)

    def _euler(self):
        """The Euler residual |mu - dE/dn| (Ha): its maximum and its
        density-weighted mean int n |mu - dE/dn| / N."""
        import torch
        s = self.s
        dEdn = s.functional_derivative("density")
        r = torch.abs(s.chemical_potential() - dEdn)
        return (float(torch.max(r)),
                float(torch.mean(s._den * r)) * s.volume("b3")
                / float(s._N_elec))

    def __call__(self, den):
        import torch
        s = self.s
        s.set_density(torch.tensor(den))
        res = []
        if self.start is not None:
            self.owner.xi_sparse = self.start
            res.append(self._euler())
        s._prepare_dynamic_kernels()
        res.append(self._euler())
        return s.energy("eV") / s.ion_count(), res

    def line(self, den):
        E, res = self(den)
        return (f"E {E:.9f} eV/atom, Euler residual max / density-weighted "
                + " ; ".join(f"{m:.3e} / {w:.3e}" for m, w in res)
                + (" Ha (start ladder ; own ladder)" if len(res) == 2
                   else " Ha"))


def f32_error(case, den):
    """Energy (ueV/atom) and potential (rel L2) error of the term's fused
    f32 sweep at ``den``, per package, against the JAX package's f64."""
    import jax.numpy as jnp
    import torch
    from professad_tpu import models as jm
    from professad_tpu.models import potentials as jpot
    from professad_tpu_torch import models as tm
    from professad_tpu_torch.models import potentials as tpot
    out = {}
    for pkg, models, vp, cast in (
            ("JAX", jm, jpot.value_and_potential,
             lambda x, dt: jnp.asarray(x, getattr(jnp, dt))),
            ("port", tm, tpot.value_and_potential,
             lambda x, dt: torch.tensor(x, dtype=getattr(torch, dt)))):
        cell, frac, _, term = _case(models, case)
        box = cell / 0.529177210903                     # bohr
        owner = getattr(term, "__self__", term)
        if hasattr(owner, "prepare"):
            owner.prepare(cast(box, "float64"), cast(den, "float64"))
        for dt in ("float64", "float32"):
            E, p = vp([term], cast(box, dt), cast(den, dt),
                      cast(np.zeros_like(den), dt))
            out[pkg, dt] = float(E), np.asarray(p, np.float64)
    E64, p64 = out["JAX", "float64"]
    lines = []
    for pkg in ("JAX", "port"):
        E32, p32 = out[pkg, "float32"]
        rel = np.linalg.norm(p32 - p64) / np.linalg.norm(p64)
        lines.append(f"{pkg} dE {(E32 - E64) * EV / len(frac) * 1e6:+.3f} "
                     f"ueV/atom, potential rel L2 {rel:.3e}")
    return "; ".join(lines)


def converge(args):
    import torch
    ev = Evaluator(args.case, args.n)
    dtypes = ("f32", "f64") if args.dtype == "both" else (args.dtype,)
    ends = {}
    for dt in dtypes:
        for pkg, fn in (("JAX", converge_jax), ("port", converge_port)):
            t0 = time.perf_counter()
            n_it, conv, den = fn(args.case, args.n, dt)
            ends[pkg, dt] = den
            print(f"converge {args.case} {args.n}^3 {dt} {pkg}: iterations "
                  f"{n_it}, converged {conv}, {time.perf_counter() - t0:.1f}"
                  f" s; {ev.line(den)}", flush=True)
    if args.dtype == "both":
        print(f"f32 error of {args.case}'s fused sweep at the port's f64 end "
              f"point: {f32_error(args.case, ends['port', 'f64'])}",
              flush=True)
    if args.continue_f64:
        for (pkg, dt), den in ends.items():
            s, _ = port_system(args.case, args.n)
            s.set_density(torch.tensor(den))
            n_it, conv = s.optimize_density(ntol=1e-12, from_uniform=False,
                                            n_maxiter=4000, **TPGD)
            print(f"continued in f64 from the {pkg} {dt} end point: "
                  f"iterations {n_it}, converged {conv}; "
                  f"{ev.line(s.density().numpy())}", flush=True)


def steps(args):
    import torch
    ntol = 1e-9 if args.case == "hc-test" else 1e-7
    for k in args.k:
        js = jax_system(args.case, args.n)
        ts, owner = port_system(args.case, args.n)
        js.optimize_density(ntol=ntol, n_maxiter=k, **TPGD)
        n_it, conv = ts.optimize_density(ntol=ntol, n_maxiter=k, **TPGD)
        d = float(np.abs(np.asarray(js._den) - ts._den.numpy()).max())
        print(f"steps {args.case} {args.n}^3 n_maxiter {k}: port {n_it} "
              f"steps, converged {conv}; E JAX {js.energy('eV'):.9f} eV, port "
              f"{ts.energy('eV'):.9f} eV; max |n_JAX - n_port| {d:.3e} "
              f"({d / float(ts._den.max()):.3e} of max n)", flush=True)
    start = getattr(owner, "xi_sparse", None)
    if start is None:
        return
    with torch.no_grad():
        E_min = float(ts._density_terms_energy(ts._box_vecs, ts._den,
                                               ts._v_ext)) * EV
        E_dir = float(ts._compute_energy(for_den_opt=True)) * EV
    own = owner.prepare(ts._box_vecs, ts._den)
    print(f"steps {args.case}: ladder prepared from the start density "
          f"{start[0]:.3f} to {start[-1]:.3f} ({len(start)} rungs), from the "
          f"port's final density {own[0]:.3f} to {own[-1]:.3f} ({len(own)} "
          f"rungs); port's energy on the start ladder minus its stored "
          f"(direct) energy {E_min - E_dir:+.6f} eV")


def card(args):
    import torch
    from chip_smoke import _nonlocal_run, nonlocal_term
    device = torch.device("cuda", 0)
    _nonlocal_run(args.case, nonlocal_term(args.case, device),
                  getattr(torch, {"f32": "float32", "f64": "float64"}[
                      args.dtype]), device, args.n, torch.cuda.synchronize)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("converge")
    c.add_argument("case")
    c.add_argument("n", type=int)
    c.add_argument("--dtype", choices=("f32", "f64", "both"), default="both")
    c.add_argument("--continue-f64", action="store_true")
    h = sub.add_parser("steps")
    h.add_argument("case")
    h.add_argument("n", type=int)
    h.add_argument("k", type=int, nargs="+")
    g = sub.add_parser("card")
    g.add_argument("case")
    g.add_argument("n", type=int)
    g.add_argument("--dtype", choices=("f32", "f64"), default="f32")
    args = ap.parse_args()
    if args.cmd == "card":
        card(args)
        return 0

    import jax
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    import torch
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    (converge if args.cmd == "converge" else steps)(args)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
