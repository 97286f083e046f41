#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: builds the spectral
convolution kernel from the checkout, holds it against its plain torch.fft
version, and drives the density-optimization main path end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build csrc/spectral_conv.cu with nvcc (sm_90a);
  3. kernel vs plain version, f32 and f64, forward and backward, at 18^3,
     (9, 15, 7) and 128^3; tolerances f32 rel 5e-6 (<= 32^3) / 2e-5
     (128^3: three O(n) FMA sums per direction), f64 rel 1e-12; per-call
     times of both at 128^3;
  4. the main path: 4-atom cubic fcc Al, 128^3, IonIon + IonElectron +
     Hartree + WangTeter + PBE, f32, System.optimize_density(TPGD,
     analytic, preconditioned) from the uniform start to dE < 1e-7 eV three
     times in a row; one warm run, then a timed run with the kernel's
     launch count reset just before it (launches >= 3 x iterations);
  5. the same system in f64: |E32 - E64| < 2e-5 eV/atom, and the per-term
     f32 energy bias of the fused sweep at the f64 ground state;
  6. the PROFESS-4 golden energy (primitive fcc Al, 18^3, f64), atol 1e-4.

Output: one line per measurement, then the kernels' JSON line, the card's
nvidia-smi line, and last {"ok": true, "device": {...}}.  Needs a CUDA
device; there is no CPU fallback.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_EV = -57.183329401794985
NTOL = 1e-7


def log(msg):
    print(msg, flush=True)


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def cuda_time_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_kernel(device):
    """Kernel vs plain version; returns the 128^3 f32 numbers."""
    import torch
    from professad_tpu_torch.ops import spectral_conv as sc

    rng = np.random.default_rng(0)
    out = {}
    for shape in ((18, 18, 18), (9, 15, 7), (128, 128, 128)):
        x_np = rng.standard_normal(shape)
        K_np = rng.random((shape[0], shape[1], shape[2] // 2 + 1))
        ct_np = rng.standard_normal(shape)
        for dt in (torch.float32, torch.float64):
            tol = 1e-12 if dt == torch.float64 else (
                2e-5 if max(shape) > 32 else 5e-6)
            K = torch.tensor(K_np, dtype=dt, device=device)
            ct = torch.tensor(ct_np, dtype=dt, device=device)
            xk = torch.tensor(x_np, dtype=dt, device=device,
                              requires_grad=True)
            xr = torch.tensor(x_np, dtype=dt, device=device,
                              requires_grad=True)
            yk = sc.spectral_conv(xk, K)
            yk.backward(ct)
            yr = sc.spectral_conv_reference(xr, K)
            yr.backward(ct)
            torch.cuda.synchronize()
            ef, eb = _rel(yk.detach(), yr.detach()), _rel(xk.grad, xr.grad)
            abs_err = float((yk.detach() - yr.detach()).abs().max())
            log(f"[kernel] {shape} {str(dt)[6:]}: fwd rel {ef:.3e} "
                f"bwd rel {eb:.3e} (tol {tol:g}) max abs {abs_err:.3e}")
            if not (ef < tol and eb < tol):
                raise AssertionError(f"kernel disagrees at {shape} {dt}")
            if shape == (128, 128, 128):
                with torch.no_grad():
                    xd = xk.detach()
                    ms = cuda_time_ms(lambda: sc.spectral_conv(xd, K), 20)
                    pms = cuda_time_ms(
                        lambda: sc.spectral_conv_reference(xd, K), 20)
                log(f"[kernel] 128^3 {str(dt)[6:]} per call: kernel "
                    f"{ms:.4f} ms, plain torch.fft {pms:.4f} ms")
                out[dt] = (abs_err, ef, ms, pms)
    return out


def build_bench_system(shape, dtype, device):
    """The benchmark configuration: 4-atom cubic fcc Al, WT + PBE."""
    from professad_tpu_torch import System
    from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                            WangTeter, PerdewBurkeErnzerhof)
    frac = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0],
                     [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]])
    pot = os.path.join(ROOT, "tests", "potentials", "al.gga.recpot")
    terms = [IonIon, IonElectron, Hartree, WangTeter, PerdewBurkeErnzerhof]
    return System(4.050 * np.eye(3), shape, [["Al", pot, frac]], terms,
                  units="a", coord_type="fractional", device=device,
                  dtype=dtype)


def optimize(system):
    return system.optimize_density(
        ntol=NTOL, n_method="TPGD", analytic=True, precondition=True,
        n_step_size=1.0, skip_iters=2, jit_loop=True, from_uniform=True)


def phase_slice(device, n, sync):
    """The main path in f32; returns (system, result dict)."""
    import torch
    from professad_tpu_torch.ops import spectral_conv as sc

    t0 = time.perf_counter()
    s = build_bench_system((n, n, n), torch.float32, device)
    sync()
    setup = time.perf_counter() - t0
    optimize(s)                                   # warm run
    sync()
    sc.launches = 0
    t0 = time.perf_counter()
    n_it, conv = optimize(s)
    sync()
    t = time.perf_counter() - t0
    launches = sc.launches
    E = s.energy("eV")
    log(f"[slice] {n}^3 f32: setup {setup:.3f} s; iterations {n_it}, "
        f"converged {conv}, E {E:.9f} eV ({E / 4:.9f} eV/atom), time to "
        f"converge {t:.4f} s, {1e3 * t / max(n_it, 1):.3f} ms/iter, "
        f"kernel launches {launches}")
    if not conv or not np.isfinite(E):
        raise AssertionError("f32 main path did not converge")
    if launches < 3 * n_it:
        raise AssertionError(f"only {launches} kernel launches for {n_it} "
                             "iterations")
    den = s.density()
    if tuple(den.shape) != (n, n, n) or not bool(torch.isfinite(den).all()):
        raise AssertionError("density is not finite on the grid")
    return s, dict(E=E, n_it=n_it, t=t, launches=launches)


def term_biases(s64):
    """Per-term f32 energy error of the fused sweep at the f64 ground
    state, in micro-eV per atom."""
    from professad_tpu_torch.models import (IonElectron, Hartree,
                                            ThomasFermi, Weizsaecker,
                                            WangTeter, PerdewBurkeErnzerhof)
    from professad_tpu_torch.models.potentials import value_and_potential
    box, den, v = s64._box_vecs, s64.density(), s64.ionic_potential()
    n_at = s64.ion_count()
    out = {}
    for term in (IonElectron, Hartree, ThomasFermi, Weizsaecker, WangTeter,
                 PerdewBurkeErnzerhof):
        E64, _ = value_and_potential([term], box, den, v)
        E32, _ = value_and_potential([term], box.float(), den.float(),
                                     v.float())
        out[term.__name__] = (float(E32) - float(E64)) * s64.eV_per_Ha \
            / n_at * 1e6
    return out


def phase_f64(device, n, E32, sync):
    import torch
    s = build_bench_system((n, n, n), torch.float64, device)
    t0 = time.perf_counter()
    n_it, conv = optimize(s)
    sync()
    t = time.perf_counter() - t0
    E64 = s.energy("eV")
    d = abs(E32 - E64) / 4
    log(f"[f64] {n}^3: iterations {n_it}, converged {conv}, E {E64:.9f} eV, "
        f"{t:.3f} s; |E32 - E64| = {d:.3e} eV/atom (bound 2e-5)")
    if not conv or d >= 2e-5:
        raise AssertionError("f32 energy outside the f64 bound")
    biases = term_biases(s)
    log("[f64] f32 energy bias per term at the f64 ground state (ueV/atom): "
        + ", ".join(f"{k} {v:+.3f}" for k, v in biases.items()))
    return E64, biases


def phase_golden(device):
    import torch
    from professad_tpu_torch import System
    from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                            WangTeter, PerdewBurkeErnzerhof)
    cell = 4.050 * np.array([[0.5, 0.5, 0.0], [0.0, 0.5, 0.5],
                             [0.5, 0.0, 0.5]])
    pot = os.path.join(ROOT, "tests", "potentials", "al.gga.recpot")
    s = System(cell, (18, 18, 18), [["Al", pot, np.zeros((1, 3))]],
               [IonIon, IonElectron, Hartree, WangTeter,
                PerdewBurkeErnzerhof], units="a", coord_type="fractional",
               device=device, dtype=torch.float64)
    n_it, conv = optimize(s)
    E = s.energy("eV")
    log(f"[golden] primitive fcc Al 18^3 f64: E {E:.9f} eV vs PROFESS-4 "
        f"{GOLDEN_EV} (diff {E - GOLDEN_EV:+.3e}, atol 1e-4), {n_it} iters")
    if not conv or abs(E - GOLDEN_EV) >= 1e-4:
        raise AssertionError("golden energy mismatch")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs the GPU",
              file=sys.stderr)
        return 1
    from professad_tpu_torch.ops import spectral_conv as sc

    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    device = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    sc.build_library()
    log(f"[build] spectral_conv.cu built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    kern = phase_kernel(device)
    _, res = phase_slice(device, 128, sync)
    phase_f64(device, 128, res["E"], sync)
    phase_golden(device)

    abs_err, _, ms, pms = kern[torch.float32]
    print(json.dumps({"kernels": [{
        "name": "spectral_conv", "route": "cuda",
        "source": "professad_tpu_torch/csrc/spectral_conv.cu",
        "replaces": "professad_tpu/ops/pallas_fft.py:229",
        "launches": res["launches"], "max_abs_err": abs_err,
        "ms": ms, "plain_ms": pms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
