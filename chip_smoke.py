#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: builds the kernels from
the checkout, holds each against its plain PyTorch version, and drives the
port's paths end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build csrc/spectral_conv.cu and csrc/stockham.cu with nvcc (sm_90a),
     one nvcc per source, both started together;
  3. spectral_conv vs its plain version, f32 and f64, forward and
     backward, at 18^3, (9, 15, 7), the odd and prime shapes (31, 37, 45),
     (61, 18, 7), (45, 45, 45), (27, 27, 39) (the geometry phase's G2
     grid), at 128^3 and 256^3; tolerances f32 rel 5e-6, f64 rel 1e-12;
     per-call times at 128^3 and at (27, 27, 39) of the kernel, its plain
     version and the bare cuFFT composition irfftn(K rfftn(x)) (three
     calls: rfftn, the product, irfftn), each issued eagerly and replayed
     from a CUDA graph (device time without the host's dispatch);
  4. the five Stockham kernels (ops/vpufft.py) vs their torch.fft versions
     at the JAX test shapes, (128, 8320) and 256^3, rel 1e-6 (max abs error
     over max |plain|); per-call times at 256^3 (eager and from a CUDA
     graph) beside the torch.fft call and the HBM bound;
  5. the butterfly path, launch counts reset just before it: the 256^3
     go/no-go of the JAX bench (chained feedback pairs
     y / (1 + mean(y^2)), 20 each) timing the cuFFT pair
     irfftn(K rfftn(x)), conv3_bfly and spectral_conv, and the unit entry
     fft_sublane -> ifft_sublane at (128, 8320); every Stockham kernel
     must launch;
  6. the main path, spectral_conv's count reset just before it: 4-atom
     cubic fcc Al, 128^3, IonIon + IonElectron + Hartree + WangTeter + PBE,
     f32, optimize_density(TPGD, analytic, preconditioned, jit_loop) from
     the uniform start to dE < 1e-7 eV three times in a row; one warm run,
     then a timed run (launches >= 3 x iterations); forces (|F| < 1e-5
     Ha/bohr by symmetry) and stress (isotropic within 1e-4 of its trace)
     at that ground state;
  7. the same system in f64: |E32 - E64| < 2e-5 eV/atom, and the per-term
     f32 energy bias of the fused sweep at the f64 ground state;
  8. the PROFESS-4 golden energies (primitive fcc Al with WT and bcc Li
     with Smargiassi-Madden, + PBE, 18^3, f64), atol 1e-4 eV, each through
     the TPGD path and through the default optimize_density() (host-loop
     L-BFGS, autograd gradient);
  9. forces against central finite differences of the re-optimized
     energy (4-atom fcc Al, 16^3, f64, one ion displaced), atol 1e-4 eV/A;
 10. geometry relaxation, f64, spectral_conv's count reset just before it,
     every density re-optimization on the analytic preconditioned TPGD
     path (ntol 1e-9): G1, the main path's cell (128^3, WT + PBE) sheared
     and with ion 0 displaced, relaxed with optimize_geometry (ions and
     cell, ftol 0.02 eV/A, stol 0.002 eV/A^3, at most 80 steps) back to
     fcc within the bounds of tests/test_geometry.py; G2, the reference's hcp-Mg tutorial
     (WT-exp + PBE) over (volume per atom, c/a) with
     optimize_parameterized_geometry at its own 2000 eV cutoff, (27, 27,
     39), into the basin of tests/test_geometry.py.  Launches must be at
     least 3 a density iteration.
 11. the ladder and kernel-table non-local functionals, spectral_conv's
     count reset just before their runs and read just after: the main path
     (128^3, f32, TPGD analytic preconditioned jit_loop, from the uniform
     start to dE < 1e-7 eV three times in a row) with each of HC, revHC,
     MGP, YukawaGGA yuk1 and yuk4, WGC99, Foley-Madden, KGAP (E_gap 1.17
     eV) and XWM as the kinetic term, yuk4 in f64 (its f32 run stops on a
     stall), HC in f32 and f64; each run prints its iterations, time,
     launches (at least 2 a density iteration, the vW Laplacian and the
     preconditioner, plus the term's own fixed-kernel convolutions), Euler
     residual, ladder length and peak device memory.  Then (a) every
     one's fused potential against autograd on the card, 32^3 f64, rtol
     1e-10; (b) at the 128^3 ground states of MGP, WGC99, FM, KGAP and XWM,
     the fused sweep with the kernel against the same sweep with its plain
     version, f32 rel 5e-6, f64 rel 1e-12; (c) HC |E32 - E64| < 2e-5
     eV/atom.  For HC and revHC it prints the xi range at the converged
     density beside the prepared ladder's.
 12. second derivatives through the ground state, spectral_conv's count
     reset just before the getters and read just after: the main path's
     cell at 128^3 f64 (TPGD to |dE| < 1e-10 eV); P, H, K, C11, C12, C44,
     Phi[0] with each getter's seconds, CG solves, iterations, residual,
     launches and peak memory; K against central differences of
     re-optimized energies at V(1 +- 4e-3), C11 and C12 against those of
     re-optimized stresses under +-4e-3 x-strain (2%), cubic symmetry
     1e-3, P = -tr(sigma)/3 1e-6, Phi[0, 1][:, 0] against differences of
     re-optimized forces, ion 1 moved +-1e-3 bohr (atol 2e-5 Ha/bohr^2),
     the CG preconditioner applied by the kernel against its plain version
     on a random field (rtol 1e-12), and the K solve's CG iterations with
     each (within 1);
 13. PME: the same cell at 128^3 f64 with pme_order=20 against the exact
     structure factor (E, density, forces, stress at np.allclose's
     defaults), and both structure factors' times;
 14. the radial preconditioner kernel at 128^3 and 320^3 (f64): against
     the same function on the CPU, against the full-grid HVP, and through
     spectral_conv against its plain version at 320^3 (f32 and f64); then
     the 320^3 main path in f32 and f64, which must pick it and converge
     (phase_radial says what is bounded).
 15. the EOS scan on the main path's cell (128^3, 9 volumes over +-5%,
     TPGD with the fused gradient, lr 1.0, ntol 1e-7, 3 hits, at most 1000
     iterations), spectral_conv's count reset just before each timed run:
     (a) the batched f32 scan, every volume a lane of one vmapped solve,
     after a warm run, timed with chi scaled by 1 + 1e-7: seconds,
     iterations per lane, converged lanes, launches (exactly 3 sites x
     iterations + 2, whatever the lane count) and peak memory; (b) the same
     per-lane solve 9 times, timed the same way; (a) and (b) fit K0 and V0
     within 1e-4 of each other; (c) the serial f64 eos_fit (jit_loop,
     preconditioned, step 1.0, ntol 1e-10), (a) within 2e-3 of it (the
     bound of tests/test_robustness.py); (d) the reference's documentation
     EOS (fcc Al, vWGTF1 + PBE, 2000 eV, f64) within the bounds of
     tests/test_docs_parity.py; (e) the batched spectral_conv against its
     plain version and lane by lane against the 3-D call at (9, 128, 128,
     128) f32 (rel 1e-5) and f64 (1e-12) and (3, 27, 27, 39) f64, per-lane
     and shared K, timed eagerly and from a CUDA graph beside the batched
     cuFFT composition and the bound; (f) set_device: a System built on
     the CPU, moved and optimized at 32^3 f64, within 1e-10 of one built on
     the card; (g) get_inv_G at 61^3 on the card: WT against Lindhard,
     KGAP against the gapped jellium, atol 1e-10.
 16. the mesh paths (multi-device runs) on one NCCL rank: a process group
     of world size 1 on cuda:0 (file:// rendezvous in a temporary
     directory), a ("batch", "grid") mesh of shape (1, 1), destroyed at the
     end of the phase.  (a) the main path through optimize_density(
     mesh=make_mesh(1), jit_loop=True, TPGD, analytic) after a warm run,
     spectral_conv's count reset just before the timed run and read just
     after (the pencil path must not launch it): seconds, iterations,
     ms/iter, peak memory, NCCL version, beside the serial [slice] run;
     |E_mesh - E_serial| < 2e-5 eV/atom and the iterations within 2;
     (b) 64^3 f64, the G1 cell compressed by 3% with ion 0 displaced,
     ntol 1e-10: the mesh solve's energy
     against the serial solve's, its forces and stress against the serial
     ones at the same density, rel 1e-12; (c) 32^3 f64: bulk_modulus on the mesh against the
     serial getter, rel 1e-10; (d) eos_fit(mesh=batch mesh, batched=True)
     against the serial batched scan (64^3, f32), 1e-4 in K0 and V0.
 17. the example workflows, spectral_conv's count reset just before the
     phase and read just after: examples/torch_density_optimization.py,
     torch_geometry_optimization.py and torch_parameterized_functionals.py,
     each main() on the card (its default device) at its own sizes, each
     with its seconds, spectral_conv launches and peak memory beside the
     card's name and power limit.  Density: the four paths' energies
     within 1e-6 eV of each other, and the analytic TPGD path's launches at
     least 3 x its iterations.  Geometry: both relaxations converge, the
     bcc-Li one within the bounds of tests/test_geometry.py (max |F| <
     0.02 eV/A, max |sigma| < 0.003 eV/A^3, the ion-ion offset within
     5e-3 of (0.5, 0.5, 0.5)).  Training: the Pauli-Gaussian and neural
     losses end below their first epoch's, the checkpoint round trip is
     bit-exact, and the ground-state training's last loss is not above
     its first (per epoch it rises at the first applied Rprop step, in
     both packages).
 18. the ion-ion pair kernel (csrc/ion_pairs.cu) at the benchmark's
     shapes: the 2048-ion fcc Al cell (1935 images) and the 96-ion hcp Mg
     cell, ions displaced by a seeded 0.10 A Gaussian, Rc six heights of
     the cell and a hair (no image exactly on the cutoff, where the two
     round apart), f64.  The autograd Function through the kernel against
     the plain torch form (_pair_energy_torch, _pair_grads_torch) on the
     same card inputs: the pair energy within 1e-12 relative, Q exactly,
     dE/dR within 1e-10 Ha/bohr and dE/dh within 1e-10 of its largest;
     then the kernel's time for an energy and for an energy with
     gradients, the torch form's, and the FP64 bound of the pairs within
     Rc (benchmark/harness/pair_roofline.py).  The kernel's launches are
     counted over the main path (phase 6: the System's set-up, the
     optimisation, forces and stress).

Output: one line per measurement, then the kernels' JSON line (its
ion_pair_sum entry: the main path's launches and phase 18's 2048-ion
numbers), the card's nvidia-smi line, and last {"ok": true, "device":
{...}}.  Needs a CUDA
device; there is no CPU fallback.
"""

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_EV = -57.183329401794985
NTOL = 1e-7
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOPS = 67e12            # FP32 outside the tensor cores


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


def graph_time_ms(fn, reps):
    """Device time per call: ``reps`` calls captured in one CUDA graph and
    replayed, so that the host's dispatch between launches does not count
    (``cuda_time_ms`` times the same calls issued eagerly)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(nbytes, flops):
    """Least time the card could take (ms): the larger of the bytes over
    the HBM rate and the FP32 operations over the FP32 peak."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


G2_SHAPE = (27, 27, 39)
KERNEL_SHAPES = ((18, 18, 18), (9, 15, 7), (31, 37, 45), (61, 18, 7),
                 (45, 45, 45), G2_SHAPE, (128, 128, 128), (256, 256, 256))


def phase_kernel(device, shapes=KERNEL_SHAPES,
                 timed=((128, 128, 128), G2_SHAPE)):
    """Kernel vs plain version; returns the numbers at each timed shape
    per (shape, dtype): (max abs error, rel error, kernel ms, plain ms,
    cuFFT ms) timed eagerly, and the same three replayed from a CUDA
    graph."""
    import torch
    from professad_tpu_torch.ops import spectral_conv as sc

    rng = np.random.default_rng(0)
    out = {}
    for shape in shapes:
        x_np = rng.standard_normal(shape)
        K_np = rng.random((shape[0], shape[1], shape[2] // 2 + 1))
        ct_np = rng.standard_normal(shape)
        for dt in (torch.float32, torch.float64):
            tol = 1e-12 if dt == torch.float64 else 5e-6
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
            if shape in timed:
                with torch.no_grad():
                    xd = xk.detach()
                    ms = cuda_time_ms(lambda: sc.spectral_conv(xd, K), 20)
                    pms = cuda_time_ms(
                        lambda: sc.spectral_conv_reference(xd, K), 20)
                    lms = cuda_time_ms(lambda: torch.fft.irfftn(
                        K * torch.fft.rfftn(xd), s=shape), 20)
                    graph = tuple(graph_time_ms(f, 20) for f in (
                        lambda: sc.spectral_conv(xd, K),
                        lambda: sc.spectral_conv_reference(xd, K),
                        lambda: torch.fft.irfftn(K * torch.fft.rfftn(xd),
                                                 s=shape)))
                    ms2 = cuda_time_ms(lambda: sc.spectral_conv(xd, K), 20)
                log(f"[kernel] {shape} {str(dt)[6:]} per call, eager: kernel "
                    f"{ms:.4f} ms (again {ms2:.4f}), plain torch.fft "
                    f"{pms:.4f} ms, cuFFT irfftn(K rfftn(x)) {lms:.4f} ms "
                    f"(kernel / cuFFT {ms / lms:.2f}x); from a CUDA graph: "
                    f"kernel {graph[0]:.4f} ms, plain {graph[1]:.4f} ms, "
                    f"cuFFT {graph[2]:.4f} ms "
                    f"({graph[0] / graph[2]:.2f}x)")
                out[shape, dt] = (abs_err, ef, ms, pms, lms, graph)
    return out


STOCKHAM = {  # name -> TPU kernel it replaces
    "fft_sublane": "professad_tpu/ops/vpufft.py:145",
    "fft_sublane_real": "professad_tpu/ops/vpufft.py:182",
    "ifft_sublane_real_out": "professad_tpu/ops/vpufft.py:222",
    "sublane_conv": "professad_tpu/ops/vpufft.py:274",
    "fft_mid": "professad_tpu/ops/vpufft.py:346",
}


def _stockham_cases(vf, torch, shape, device, rng):
    """(name, kernel fn, plain fn, args, library call or None, bytes,
    flops) for every Stockham entry at one (n, B) shape, and for fft_mid
    at (n, B / n, n) where B / n is a power of two."""
    f32 = dict(dtype=torch.float32, device=device)
    n, B = shape
    a, b, k = (torch.tensor(rng.standard_normal(shape), **f32)
               for _ in range(3))
    z = torch.complex(a, b)
    logn = int(np.log2(n))
    N = n * B
    plane = 4 * N
    cases = [
        ("fft_sublane", vf.fft_sublane, vf.fft_sublane_reference, (a, b),
         lambda: torch.fft.fft(z, dim=0), 4 * plane, 5 * N * logn),
        ("ifft_sublane", vf.ifft_sublane, vf.ifft_sublane_reference, (a, b),
         lambda: torch.fft.ifft(z, dim=0), 4 * plane, 5 * N * logn),
        ("fft_sublane_real", vf.fft_sublane_real,
         vf.fft_sublane_real_reference, (a,),
         lambda: torch.fft.fft(a, dim=0), 3 * plane, 2.5 * N * logn),
        ("ifft_sublane_real_out", vf.ifft_sublane_real_out,
         vf.ifft_sublane_real_out_reference, (a, b),
         lambda: torch.fft.ifft(z, dim=0), 3 * plane, 2.5 * N * logn),
        ("sublane_conv", vf.sublane_conv, vf.sublane_conv_reference,
         (a, b, k), None, 5 * plane, 10 * N * logn + 2 * N),
    ]
    n1 = B // n
    if B % n == 0 and n1 & (n1 - 1) == 0:
        a3, b3 = a.reshape(n, n1, n), b.reshape(n, n1, n)
        z3 = torch.complex(a3, b3)
        l1 = int(np.log2(n1))
        cases += [
            ("fft_mid", vf.fft_mid, vf.fft_mid_reference, (a3, b3),
             lambda: torch.fft.fft(z3, dim=1), 4 * plane, 5 * N * l1),
            ("ifft_mid", vf.ifft_mid, vf.ifft_mid_reference, (a3, b3),
             lambda: torch.fft.ifft(z3, dim=1), 4 * plane, 5 * N * l1),
        ]
    return cases


def phase_stockham(device, shapes=((32, 256), (16, 256), (128, 8320),
                                   (256, 256 * 256))):
    """The Stockham kernels vs their plain versions; returns the numbers
    per kernel at the last shape (256^3), where they are timed."""
    import torch
    from professad_tpu_torch.ops import vpufft as vf

    tol = 1e-6
    rng = np.random.default_rng(1)
    out = {}
    for shape in shapes:
        timed = shape == shapes[-1]
        for (name, fn, ref, args, lib, nbytes,
             flops) in _stockham_cases(vf, torch, shape, device, rng):
            got, want = fn(*args), ref(*args)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            abs_err = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
            rel = abs_err / max(float(w.abs().max()) for w in want)
            msg = (f"[stockham] {name} {tuple(args[0].shape)}: rel "
                   f"{rel:.3e} (tol {tol:g}) max abs {abs_err:.3e}")
            if not rel < tol:
                raise AssertionError(msg)
            if timed:
                ms = cuda_time_ms(lambda: fn(*args), 20)
                pms = cuda_time_ms(lambda: ref(*args), 20)
                lms = None if lib is None else cuda_time_ms(lib, 20)
                gms = graph_time_ms(lambda: fn(*args), 20)
                glms = None if lib is None else graph_time_ms(lib, 20)
                bms, by = bound(nbytes, flops)
                out[name] = dict(max_abs_err=abs_err, ms=ms, plain_ms=pms,
                                 library_ms=lms, bound_ms=bms, bound_by=by,
                                 graph_ms=gms, library_graph_ms=glms)
                msg += (f"; kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                        f"torch.fft call "
                        f"{'n/a' if lms is None else f'{lms:.4f} ms'}, "
                        f"bound {bms:.4f} ms ({by}, "
                        f"{100 * bms / ms:.1f}% of it); from a CUDA graph: "
                        f"kernel {gms:.4f} ms ({100 * bms / gms:.1f}%), "
                        f"torch.fft call "
                        f"{'n/a' if glms is None else f'{glms:.4f} ms'}")
            log(msg)
    return out


def _pair_kernels(n):
    """The go/no-go's input and kernels: K = 1 / (1 + 0.05 k^2) on the
    integer frequencies (Hermitian-even), full, half and (z, y, x)."""
    rng = np.random.default_rng(0)
    x0 = (1.0 + 0.01 * rng.standard_normal((n, n, n))).astype(np.float32)
    kx = np.fft.fftfreq(n) * n
    k2 = (kx[:, None, None] ** 2 + kx[None, :, None] ** 2
          + kx[None, None, :] ** 2)
    K_full = (1.0 / (1.0 + 0.05 * k2)).astype(np.float32)
    return x0, K_full


def phase_bfly(device, n=256, iters=20):
    """The butterfly path: the JAX bench's 256^3 go/no-go
    (bench.py:586-637) over three chained conv-pair programs, and the unit
    entry fft_sublane -> ifft_sublane at the production half-spectrum
    x-axis shape (128, 8320).  Returns the launch counts of this phase."""
    import torch
    from professad_tpu_torch.ops import spectral_conv as sc
    from professad_tpu_torch.ops import vpufft as vf

    f32 = dict(dtype=torch.float32, device=device)
    x0_np, K_np = _pair_kernels(n)
    x0 = torch.tensor(x0_np, **f32)
    K_half = torch.tensor(np.ascontiguousarray(K_np[:, :, : n // 2 + 1]),
                          **f32)
    K_t = torch.tensor(np.ascontiguousarray(np.transpose(K_np, (2, 1, 0))),
                       **f32)
    shape = (n, n, n)

    def feedback(y):
        return y / (1.0 + torch.mean(y * y))

    programs = {
        "cuFFT pair": lambda x: feedback(torch.fft.irfftn(
            K_half * torch.fft.rfftn(x), s=shape)),
        "conv3_bfly": lambda x: feedback(vf.conv3_bfly(x, K_t)),
        "spectral_conv": lambda x: feedback(sc.spectral_conv(x, K_half)),
    }

    def chain_ms(step):
        x = x0
        for _ in range(3):
            x = step(x)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            x = step(x)
        stop.record()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(x).all()):
            raise AssertionError("non-finite chained output")
        return start.elapsed_time(stop) / iters

    for key in vf.launches:
        vf.launches[key] = 0
    with torch.no_grad():
        y = {k: step(x0) for k, step in programs.items()}
        torch.cuda.synchronize()
        ref = y["cuFFT pair"]
        rel = {k: float((v - ref).abs().max() / ref.abs().max())
               for k, v in y.items() if k != "cuFFT pair"}
        ms = {k: chain_ms(step) for k, step in programs.items()}
        # the unit entry: c2c forward and inverse along axis 0
        rng = np.random.default_rng(2)
        ar, ai = (torch.tensor(rng.standard_normal((128, 8320)), **f32)
                  for _ in range(2))
        br, bi = vf.ifft_sublane(*vf.fft_sublane(ar, ai))
        torch.cuda.synchronize()
        rt = float(torch.maximum((br - ar).abs().max(),
                                 (bi - ai).abs().max()))
    counts = dict(vf.launches)
    base = ms["cuFFT pair"]
    log(f"[bfly] {n}^3 go/no-go, ms per chained pair: cuFFT "
        f"{base:.4f}, conv3_bfly {ms['conv3_bfly']:.4f} "
        f"({ms['conv3_bfly'] / base:.2f}x), spectral_conv "
        f"{ms['spectral_conv']:.4f} ({ms['spectral_conv'] / base:.2f}x); "
        f"rel err vs cuFFT: conv3_bfly {rel['conv3_bfly']:.3e}, "
        f"spectral_conv {rel['spectral_conv']:.3e} (tol 2e-5)")
    log(f"[bfly] unit entry fft_sublane -> ifft_sublane (128, 8320): max "
        f"round-trip error {rt:.3e} (tol 1e-5); launches {counts}")
    if not (rel["conv3_bfly"] < 2e-5 and rel["spectral_conv"] < 2e-5
            and rt < 1e-5):
        raise AssertionError("butterfly path disagrees with cuFFT")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"Stockham kernels never launched: {missing}")
    bytes_pair = 3 * 4 * n ** 3
    bms, by = bound(bytes_pair, 3 * 5 * n ** 3 * np.log2(n) * 2)
    log(f"[bfly] whole conv3_bfly bound {bms:.4f} ms ({by}); "
        f"{100 * bms / ms['conv3_bfly']:.1f}% of it")
    return counts


FCC = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0],
                [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]])


def build_bench_system(shape, dtype, device, cell=4.050 * np.eye(3),
                       frac=FCC, kinetic=None, pme_order=None):
    """The benchmark configuration: 4-atom cubic fcc Al, PBE and the
    kinetic term ``kinetic`` (WT by default); ``pme_order`` selects the
    PME structure factor."""
    from professad_tpu_torch import System
    from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                            WangTeter, PerdewBurkeErnzerhof)
    pot = os.path.join(ROOT, "tests", "potentials", "al.gga.recpot")
    terms = [IonIon, IonElectron, Hartree,
             WangTeter if kinetic is None else kinetic,
             PerdewBurkeErnzerhof]
    return System(cell, shape, [["Al", pot, frac]], terms,
                  units="a", coord_type="fractional", device=device,
                  dtype=dtype, pme_order=pme_order)


def optimize(system):
    # the longest run, Yukawa yuk4 in f64 at 128^3, takes 3732 iterations
    return system.optimize_density(
        ntol=NTOL, n_method="TPGD", analytic=True, precondition=True,
        n_step_size=1.0, skip_iters=2, jit_loop=True, from_uniform=True,
        n_maxiter=5000)


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


def phase_derivatives(s):
    """Forces and stress at the 128^3 f32 ground state of the main path
    (evaluated in f64 on the stored state): every ion of the cubic cell
    sits at a centre of symmetry, so the forces vanish, and the stress of
    a cubic cell on a cubic grid is isotropic."""
    import torch
    E0 = s.energy()
    t0 = time.perf_counter()
    F = s.forces()
    sigma = s.stress()
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    fmax = float(F.abs().max())
    p = float(torch.trace(sigma)) / 3.0
    aniso = float((sigma - p * torch.eye(3, dtype=sigma.dtype,
                                         device=sigma.device)).abs().max())
    log(f"[derivatives] {s.density().shape[0]}^3 ground state: max |F| "
        f"{fmax:.3e} Ha/bohr "
        f"(bound 1e-5); stress diag {[f'{v:.6e}' for v in sigma.diag()]}"
        f" Ha/bohr^3, pressure {-p * s.GPa_per_atomic:.6f} GPa, max "
        f"|sigma - p I| / |p| {aniso / abs(p):.3e} (bound 1e-4); {t:.3f} s")
    if not (fmax < 1e-5 and aniso < 1e-4 * abs(p)):
        raise AssertionError("forces or stress break the cell's symmetry")
    if s.energy() != E0:
        raise AssertionError("forces/stress changed the stored energy")


def phase_fd_forces(device, eps=1e-4):
    """Forces against central finite differences of the energy,
    re-optimized through the default optimize_density() at each
    displacement: 4-atom fcc Al, 16^3, f64, ion 1 displaced."""
    import torch
    s = build_bench_system((16, 16, 16), torch.float64, device)
    R = s.cartesian_ionic_coordinates("a").cpu().numpy()
    R[1] += np.array([0.03, -0.02, 0.05])
    s.place_ions(R, units="a")
    t0 = time.perf_counter()
    n_it, conv = s.optimize_density(ntol=1e-8)
    F = s.forces("eV/a").cpu().numpy()[1]
    F_fd = np.zeros(3)
    for axis in range(3):
        E = []
        for sign in (1.0, -1.0):
            Rd = R.copy()
            Rd[1, axis] += sign * eps
            s.place_ions(Rd, units="a")
            s.optimize_density(ntol=1e-8)
            E.append(s.energy("eV"))
        F_fd[axis] = -(E[0] - E[1]) / (2 * eps)
    err = float(np.abs(F - F_fd).max())
    log(f"[fd] 16^3 f64, default optimize_density ({n_it} outer steps, "
        f"converged {conv}): F {F} eV/A, central differences {F_fd}, max "
        f"diff {err:.3e} (atol 1e-4); {time.perf_counter() - t0:.2f} s")
    if not conv or err >= 1e-4:
        raise AssertionError("forces disagree with finite differences")


GEO_DEN_OPT = dict(n_method="TPGD", jit_loop=True, analytic=True,
                   precondition=True, n_step_size=1.0, skip_iters=2,
                   ntol=1e-9)
SHEAR = np.array([[1.0, 0.02, 0.0], [0.0, 1.0, 0.03], [0.01, 0.0, 1.0]])


def _instrument(s):
    """Count the density re-optimizations (iterations, whether each
    converged, the energy after each) and the geometry value-and-gradient
    calls of one relaxation, with the host time spent in each (both end in
    a read of a device scalar, so the time includes the device's)."""
    stats = dict(runs=[], vg=0, t_vg=0.0, t_den=0.0)
    run, make = s.optimize_density, s._geometry_value_and_grad

    def den_opt(**kw):
        t0 = time.perf_counter()
        n_it, conv = run(**kw)
        stats["t_den"] += time.perf_counter() - t0
        stats["runs"].append((n_it, conv, s.energy("eV") / s.ion_count()))
        return n_it, conv

    def make_counted(*args):
        vg = make(*args)

        def counted(x):
            t0 = time.perf_counter()
            out = vg(x)
            stats["t_vg"] += time.perf_counter() - t0
            stats["vg"] += 1
            return out
        return counted
    s.optimize_density = den_opt
    s._geometry_value_and_grad = make_counted
    return stats


def _report(tag, stats, t, launches):
    runs = stats["runs"]
    n_den = sum(r[0] for r in runs)
    unconv = sum(not r[1] for r in runs)
    log(f"[geometry] {tag}: {len(runs) - 1} geometry steps, {n_den} density "
        f"iterations in {len(runs)} re-optimizations ({unconv} not "
        f"converged), {stats['vg']} value-and-gradient calls, {t:.3f} s "
        f"(density re-optimizations {stats['t_den']:.3f} s, "
        f"value-and-gradient {stats['t_vg']:.3f} s, the rest - forces, "
        f"stress, host - {t - stats['t_den'] - stats['t_vg']:.3f} s), "
        f"spectral_conv launches {launches} (bound >= 3 x {n_den}); E/atom "
        f"{runs[0][2]:.6f} -> {runs[-1][2]:.6f} eV")
    if launches < 3 * n_den:
        raise AssertionError(f"{tag}: only {launches} spectral_conv "
                             f"launches for {n_den} density iterations")
    return n_den


def _angles(box):
    a, b, c = box
    cos = [np.dot(u, v) / np.linalg.norm(u) / np.linalg.norm(v)
           for u, v in ((b, c), (a, c), (a, b))]
    return np.degrees(np.arccos(cos))


def geometry_g1(device, sync, n=128):
    """G1: the main path's cell sheared, ion 0 displaced, relaxed with
    optimize_geometry back to fcc.  Returns its numbers and whether it
    met every bound."""
    import torch
    from professad_tpu_torch.ops import spectral_conv as sc
    frac = FCC.copy()
    frac[0] += (0.02, 0.0, 0.01)
    s = build_bench_system((n, n, n), torch.float64, device,
                           cell=4.050 * SHEAR, frac=frac)
    stats = _instrument(s)
    sync()
    before = sc.launches
    t0 = time.perf_counter()
    ok = s.optimize_geometry(ftol=0.02, stol=0.002,
                             g_method="LBFGSlinesearch", g_maxiter=80,
                             g_verbose=True, **GEO_DEN_OPT)
    sync()
    t = time.perf_counter() - t0
    launches = sc.launches - before
    n_den = _report(f"G1 fcc Al {n}^3 f64, ions + cell", stats, t,
                    launches)
    F = float(s.forces("eV/a").abs().max())
    sigma = float(s.stress("eV/a3").abs().max())
    box = s.lattice_vectors("a").cpu().numpy()
    lengths = np.linalg.norm(box, axis=1)
    angles = _angles(box)
    rel = (s.fractional_ionic_coordinates().cpu().numpy()
           - s.fractional_ionic_coordinates().cpu().numpy()[0])
    off = np.abs((rel - FCC + 0.5) % 1.0 - 0.5).max()
    E0, E1 = stats["runs"][0][2], stats["runs"][-1][2]
    log(f"[geometry] G1: converged {ok}; max |F| {F:.3e} eV/A (< 0.02), "
        f"max |sigma| {sigma:.3e} eV/A^3 (< 0.002); edges "
        f"{[f'{v:.5f}' for v in lengths]} A (3.8-4.2), angles "
        f"{[f'{v:.4f}' for v in angles]} deg (90 +- 1), ions off the fcc "
        f"sites by {off:.2e} (< 5e-3); E/atom {E0:.6f} -> {E1:.6f} eV")
    passed = bool(ok and F < 0.02 and sigma < 0.002 and E1 < E0
                  and off < 5e-3
                  and np.all((lengths > 3.8) & (lengths < 4.2))
                  and np.all(np.abs(angles - 90.0) < 1.0))
    return dict(steps=len(stats["runs"]) - 1, n_den=n_den, vg=stats["vg"],
                t=t, launches=launches, passed=passed)


def _hcp_geometry(p):
    """(volume per atom [bohr^3], c/a) -> hcp (box [bohr], frac), the
    parameterization of tests/test_geometry.py in torch ops."""
    import torch
    z = dict(dtype=p.dtype, device=p.device)
    vol, c_over_a = torch.abs(p[0]), torch.abs(p[1])
    a = ((2.0 * vol) / (np.sqrt(3.0) / 2.0 * c_over_a)) ** (1.0 / 3.0)
    rows = torch.tensor([[1.0, 0.0, 0.0], [-0.5, np.sqrt(3.0) / 2.0, 0.0],
                         [0.0, 0.0, 1.0]], **z)
    scale = torch.stack([torch.ones((), **z), torch.ones((), **z), c_over_a])
    frac = torch.tensor([[1 / 3, 2 / 3, 0.75], [2 / 3, 1 / 3, 0.25]], **z)
    return a * rows * scale[:, None], frac


def geometry_g2(device, sync):
    """G2: the reference's hcp-Mg tutorial, WT-exp + PBE over (volume per
    atom, c/a), at its own 2000 eV cutoff."""
    import torch
    from professad_tpu_torch import System
    from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                            WangTeterStyleFunctional,
                                            PerdewBurkeErnzerhof)
    from professad_tpu_torch.ops import spectral_conv as sc
    A3 = System.A_per_b ** 3
    wt_exp = WangTeterStyleFunctional(
        (5.0 / 6.0, 5.0 / 6.0, torch.exp)).to(device)
    p0 = torch.tensor([24.0 / A3, 1.5], dtype=torch.float64)
    box0, frac0 = _hcp_geometry(p0)
    shape = System.ecut2shape(2000.0, box0.numpy() * System.A_per_b)
    if shape != G2_SHAPE:
        raise AssertionError(f"G2 grid {shape}, expected {G2_SHAPE}")
    pot = os.path.join(ROOT, "tests", "potentials", "mg.gga.recpot")
    s = System(box0.numpy(), shape, [["Mg", pot, frac0.numpy()]],
               [IonIon, IonElectron, Hartree, wt_exp.forward,
                PerdewBurkeErnzerhof], units="b", coord_type="fractional",
               device=device, dtype=torch.float64)
    stats = _instrument(s)
    sync()
    before = sc.launches
    t0 = time.perf_counter()
    ok, p = s.optimize_parameterized_geometry(
        p0, _hcp_geometry, ftol=1e-3, stol=1e-3, g_method="LBFGSlinesearch",
        g_maxiter=40, g_verbose=True, **GEO_DEN_OPT)
    sync()
    t = time.perf_counter() - t0
    launches = sc.launches - before
    n_den = _report(f"G2 hcp Mg {shape} f64, (V, c/a)", stats, t, launches)
    V, c_over_a = float(p[0].abs()) * A3, float(p[1].abs())
    log(f"[geometry] G2: converged {ok}; V {V:.4f} A^3/atom (21.0-25.5; "
        f"reference docs 23.151, diff {V - 23.151:+.4f}), c/a "
        f"{c_over_a:.4f} (1.55-1.70; reference docs 1.630, diff "
        f"{c_over_a - 1.630:+.4f})")
    passed = bool(ok and 21.0 < V < 25.5 and 1.55 < c_over_a < 1.70)
    return dict(steps=len(stats["runs"]) - 1, n_den=n_den, vg=stats["vg"],
                t=t, launches=launches, V=V, c_over_a=c_over_a,
                passed=passed)


def phase_geometry(device, sync, n=128):
    """Both relaxations; spectral_conv's count is reset just before and
    read just after.  Returns the launches and the per-case numbers."""
    from professad_tpu_torch.ops import spectral_conv as sc
    t0 = time.perf_counter()
    sc.launches = 0
    g1 = geometry_g1(device, sync, n)
    g2 = geometry_g2(device, sync)
    launches = sc.launches
    log(f"[geometry] phase: {time.perf_counter() - t0:.3f} s, "
        f"spectral_conv launches {launches}")
    failed = [tag for tag, g in (("G1", g1), ("G2", g2)) if not g["passed"]]
    if failed:
        raise AssertionError(f"relaxation outside its bounds: {failed}")
    return launches, g1, g2


NONLOCAL_NAMES = ("HuangCarter", "RevisedHuangCarter", "MiGenovaPavanello",
                  "YukawaGGA-yuk1", "YukawaGGA-yuk4", "WangGovindCarter99",
                  "FoleyMadden", "KGAP", "XuWangMa")


def nonlocal_term(name, device=None, models=None):
    """The non-local kinetic term ``name`` (one of NONLOCAL_NAMES) as a user
    passes it, with the parameters of
    tests/test_advanced_functional_derivatives.py, built from ``models``
    (the port's by default; the JAX package's builds the same term), its
    module on ``device`` when one is given."""
    from functools import partial
    if models is None:
        from professad_tpu_torch import models

    def placed(module):
        return (module if device is None else module.to(device)).forward
    if name.startswith("YukawaGGA-"):
        y = models.YukawaGGA()
        getattr(y, "set_" + name.split("-")[1])()
        return placed(y)
    return {
        "HuangCarter": lambda: placed(models.HuangCarter(
            (0.01177, 0.7143, 1.2))),
        "RevisedHuangCarter": lambda: placed(models.RevisedHuangCarter(
            (0.45, 0.10, 0.7143, 1.2))),
        "MiGenovaPavanello": lambda: placed(models.MiGenovaPavanello(
            (0.2, 0.1))),
        "WangGovindCarter99": lambda: placed(models.WangGovindCarter99()),
        "FoleyMadden": lambda: placed(models.FoleyMadden()),
        "KGAP": lambda: partial(models.KGAP, E_gap=1.17),
        "XuWangMa": lambda: models.XuWangMa,
    }[name]()


KERNEL_TABLE_TERMS = ("MiGenovaPavanello", "WangGovindCarter99",
                      "FoleyMadden", "KGAP", "XuWangMa")
# (name, dtype) of the phase's runs.  Yukawa yuk4 runs in f64: its descent
# stalls far from the minimum and |dE| < 1e-7 eV fires on the stall, at a
# point that depends on rounding (f32 and f64, JAX and the port land
# apart; nonlocal_rehearsal.py), so an f32 run's energy is not held; HC
# runs in both for check (c).
NONLOCAL_RUNS = tuple((name, "float32") for name in NONLOCAL_NAMES
                      if name != "YukawaGGA-yuk4") + (
    ("YukawaGGA-yuk4", "float64"), ("HuangCarter", "float64"))
# spectral_conv calls per gradient evaluation: the vW Laplacian and the
# preconditioner, plus the term's fixed-kernel convolutions (the ladder
# terms convolve through torch.fft)
CALLS_PER_ITER = {"MiGenovaPavanello": 3, "WangGovindCarter99": 14,
                  "FoleyMadden": 3, "KGAP": 4, "XuWangMa": 6}


def _nonlocal_run(name, term, dtype, device, n, sync):
    """One density optimization of the main path's cell with ``term`` as
    the kinetic functional; returns its numbers and its final state.  The
    Euler residual max |mu - dE/dn| (Ha) is taken at the final density on
    the ladder the run minimized on."""
    import torch
    from professad_tpu_torch.ops import spectral_conv as sc
    owner = getattr(term, "__self__", term)
    s = build_bench_system((n, n, n), dtype, device, kinetic=term)
    sync()
    torch.cuda.reset_peak_memory_stats(device)
    before = sc.launches
    t0 = time.perf_counter()
    n_it, conv = optimize(s)
    sync()
    t = time.perf_counter() - t0
    launches = sc.launches - before
    ladder = getattr(owner, "xi_sparse", None)
    if ladder is not None and "HuangCarter" in name:
        # does the ladder prepared from the start density cover xi at the
        # converged density?
        with torch.no_grad():
            xis = owner._xis(owner.params, s._box_vecs, s.density())
        log(f"[nonlocal] {name} {n}^3 {str(dtype)[6:]}: xi at the converged "
            f"density [{float(xis.min()):.6g}, {float(xis.max()):.6g}], "
            f"prepared ladder [{ladder[0]:.6g}, {ladder[-1]:.6g}]")
    r = dict(name=name, dtype=str(dtype)[6:], n_it=n_it, conv=bool(conv),
             t=t, launches=launches, E=s.energy("eV"),
             L=None if ladder is None else len(ladder),
             mem=torch.cuda.max_memory_allocated(device),
             euler=s.check_density_convergence("euler"),
             state=(s._box_vecs, s.density(), s.ionic_potential()))
    log(f"[nonlocal] {name} {n}^3 {r['dtype']}: iterations {n_it}, "
        f"converged {conv}, {t:.3f} s, {1e3 * t / max(n_it, 1):.3f} "
        f"ms/iter, E {r['E']:.9f} eV ({r['E'] / 4:.9f} eV/atom), "
        f"Euler residual {r['euler']:.3e} Ha, spectral_conv launches "
        f"{launches}, ladder length {'-' if ladder is None else r['L']}, "
        f"max memory allocated {r['mem'] / 2**20:.1f} MiB")
    return r


def _rel_scalar(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def check_autograd(device, terms, n=32):
    """(a) For every non-local term at n^3 in f64 on the card: the fused
    potential against autograd of the energy (torch.fft), rtol 1e-10."""
    import torch
    from professad_tpu_torch.models.potentials import value_and_potential
    from professad_tpu_torch.ops.autodiff import get_functional_derivative
    rng = np.random.default_rng(5)
    z = dict(dtype=torch.float64, device=device)
    box = torch.tensor(7.3 * np.eye(3) + 0.15 * rng.standard_normal((3, 3)),
                       **z)
    den = torch.tensor(0.25 + 0.1 * rng.random((n, n, n)), **z)
    v = torch.zeros_like(den)
    bad = []
    for name, term in terms.items():
        owner = getattr(term, "__self__", term)
        energy = term
        if hasattr(owner, "prepare"):
            owner.prepare(box, den)
            energy = getattr(owner, "forward_static", term)
        E, pot = value_and_potential([term], box, den, v)
        g = get_functional_derivative(box, den, energy).detach()
        with torch.no_grad():
            E_ref = term(box, den)
        rel = _rel(pot, g)
        rel_E = _rel_scalar(E, E_ref)
        log(f"[nonlocal] (a) {name} {n}^3 f64: fused potential vs autograd "
            f"rel {rel:.3e}, energy rel {rel_E:.3e} (tol 1e-10)")
        if not (rel < 1e-10 and rel_E < 1e-10):
            bad.append(name)
    return bad


def check_kernel_sweep(runs, terms, n):
    """(b) At the n^3 ground states of the kernel-table terms:
    value_and_potential with the CUDA spectral_conv against the same sweep
    with its plain version swapped in, f32 rel 5e-6, f64 rel 1e-12."""
    import torch
    from professad_tpu_torch.models.potentials import value_and_potential
    from professad_tpu_torch.ops import spectral_conv as sc
    bad = []
    kernel = sc.spectral_conv
    for r in runs:
        if r["name"] not in KERNEL_TABLE_TERMS or r["dtype"] != "float32":
            continue
        term = terms[r["name"]]
        for dt, tol in ((torch.float32, 5e-6), (torch.float64, 1e-12)):
            box, den, v = (x.to(dt) for x in r["state"])
            out = {}
            for tag, fn in (("kernel", kernel),
                            ("plain", sc.spectral_conv_reference)):
                sc.spectral_conv = fn
                try:
                    out[tag] = value_and_potential([term], box, den, v)
                finally:
                    sc.spectral_conv = kernel
            torch.cuda.synchronize()
            (Ek, pk), (Ep, pp) = out["kernel"], out["plain"]
            rel, rel_E = _rel(pk, pp), _rel_scalar(Ek, Ep)
            log(f"[nonlocal] (b) {r['name']} {n}^3 {str(dt)[6:]}: sweep "
                f"with the kernel vs its plain version, potential rel "
                f"{rel:.3e}, energy rel {rel_E:.3e} (tol {tol:g})")
            if not (rel <= tol and rel_E <= tol):
                bad.append(f"{r['name']} {dt}")
    return bad


def phase_nonlocal(device, sync, n=128):
    """The non-local functionals on the main path: each the kinetic term of
    the 4-atom fcc Al cell at n^3, f32 (Yukawa yuk4 in f64),
    optimize_density (TPGD, analytic, preconditioned, jit_loop) from the
    uniform start to |dE| < 1e-7 eV three times in a row, HC again in f64
    (NONLOCAL_RUNS); spectral_conv's count is reset
    just before the runs and read just after.  Then (a) fused potentials
    against autograd at 32^3 f64, (b) the kernel-table terms' sweep with
    the kernel against its plain version, (c) HC's |E32 - E64| <
    2e-5 eV/atom.  Returns the runs' launches and their numbers."""
    import torch
    from professad_tpu_torch.ops import spectral_conv as sc
    t0 = time.perf_counter()
    terms = {name: nonlocal_term(name, device) for name in NONLOCAL_NAMES}
    sc.launches = 0
    runs = [_nonlocal_run(name, terms[name], getattr(torch, dt), device, n,
                          sync) for name, dt in NONLOCAL_RUNS]
    launches = sc.launches
    failed = [f"{r['name']} {r['dtype']} did not converge" for r in runs
              if not (r["conv"] and np.isfinite(r["E"]))]
    failed += [f"{r['name']}: {r['launches']} launches for {r['n_it']} "
               "iterations" for r in runs
               if r["launches"] < CALLS_PER_ITER.get(r["name"], 2) * r["n_it"]]
    failed += [f"(a) {b}" for b in check_autograd(device, terms)]
    failed += [f"(b) {b}" for b in check_kernel_sweep(runs, terms, n)]
    E32, E64 = runs[0]["E"], runs[-1]["E"]
    d = abs(E32 - E64) / 4
    log(f"[nonlocal] (c) HuangCarter {n}^3: |E32 - E64| = {d:.3e} eV/atom "
        f"(bound 2e-5)")
    if not d < 2e-5:
        failed.append("(c) HC f32 energy outside the f64 bound")
    log(f"[nonlocal] phase: {time.perf_counter() - t0:.3f} s, spectral_conv "
        f"launches {launches} (in the runs)")
    if failed:
        raise AssertionError(f"nonlocal phase: {failed}")
    for r in runs:
        del r["state"]
    return launches, runs


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


GOLDEN = (  # tests/test_match_profess4.py
    ("primitive fcc Al, WT", "Al", "al.gga.recpot",
     4.050 * np.array([[0.5, 0.5, 0.0], [0.0, 0.5, 0.5], [0.5, 0.0, 0.5]]),
     np.zeros((1, 3)), "WangTeter", GOLDEN_EV),
    ("bcc Li, SM", "Li", "li.gga.recpot", 3.48 * np.eye(3),
     np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]]), "SmargiassiMadden",
     -14.741886997024537),
)


def phase_golden(device):
    import torch
    from professad_tpu_torch import System
    from professad_tpu_torch import models
    for name, species, recpot, cell, frac, kinetic, golden in GOLDEN:
        pot = os.path.join(ROOT, "tests", "potentials", recpot)
        s = System(cell, (18, 18, 18), [[species, pot, frac]],
                   [models.IonIon, models.IonElectron, models.Hartree,
                    getattr(models, kinetic), models.PerdewBurkeErnzerhof],
                   units="a", coord_type="fractional", device=device,
                   dtype=torch.float64)
        for path, run in (("TPGD path", optimize),
                          ("default optimize_density()",
                           lambda s: s.optimize_density(ntol=NTOL))):
            s.initialize_density()
            t0 = time.perf_counter()
            n_it, conv = run(s)
            torch.cuda.synchronize()
            t = time.perf_counter() - t0
            E = s.energy("eV")
            log(f"[golden] {name} 18^3 f64, {path}: E {E:.9f} eV vs "
                f"PROFESS-4 {golden} (diff {E - golden:+.3e}, atol 1e-4), "
                f"{n_it} steps, {t:.3f} s")
            if not conv or abs(E - golden) >= 1e-4:
                raise AssertionError(f"golden energy mismatch ({name}, "
                                     f"{path})")


SECOND_NTOL = 1e-10


def _second_optimize(s, ntol=SECOND_NTOL):
    n_it, conv = s.optimize_density(
        ntol=ntol, n_method="TPGD", analytic=True, precondition=True,
        n_step_size=1.0, skip_iters=2, jit_loop=True, n_maxiter=5000)
    if not conv:
        raise AssertionError("[second] density optimization did not converge")
    return n_it


def _getter(tag, fn, device):
    """Run one getter; print its seconds, CG solves, iterations per solve,
    largest post-solve residual, spectral_conv launches and peak memory."""
    import torch
    from professad_tpu_torch.ops import implicit
    from professad_tpu_torch.ops import spectral_conv as sc
    implicit.solves.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    before = sc.launches
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    its = [k for k, _ in implicit.solves]
    res = max([r for _, r in implicit.solves if r is not None], default=0.0)
    log(f"[second] {tag}: {t:.3f} s, CG solves {len(its)}, iterations "
        f"{its}, max post-solve residual {res:.3e}, spectral_conv launches "
        f"{sc.launches - before}, max memory allocated "
        f"{torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB")
    return out, dict(t=t, solves=len(its), iters=its, residual=res)


def phase_second(device, n=128):
    """Second derivatives through the ground state of the main path's cell
    (n^3, f64, TPGD to |dE| < 1e-10 eV): P, H, K, C11, C12, C44 and
    Phi[0], each against finite differences of re-optimized states (K and
    C 2%, Phi atol 2e-5 Ha/bohr^2), cubic symmetry 1e-3, P = -tr(sigma)/3
    1e-6; the CG preconditioner applied by the kernel against its plain
    version on a random field (rtol 1e-12) and the K solve's CG iterations
    with each (within 1).  Returns the kernel's launches."""
    import torch
    from professad_tpu_torch.ops import implicit
    from professad_tpu_torch.ops import spectral_conv as sc
    s = build_bench_system((n, n, n), torch.float64, device)
    GPA = s.GPa_per_atomic
    t0 = time.perf_counter()
    n_it = _second_optimize(s)
    log(f"[second] {n}^3 f64 ground state: {n_it} iterations, "
        f"{time.perf_counter() - t0:.3f} s, E {s.energy('eV'):.9f} eV")
    sc.launches = 0
    P, _ = _getter("pressure", lambda: s.pressure("GPa"), device)
    H, _ = _getter("enthalpy", lambda: s.enthalpy("eV"), device)
    K, kst = _getter("bulk_modulus", lambda: s.bulk_modulus("GPa"), device)
    C, cst = _getter("elastic_constants",
                     lambda: s.elastic_constants("GPa").cpu().numpy(), device)
    FC, fst = _getter("force_constants [0]",
                      lambda: s.force_constants([0], "Ha/b2").cpu().numpy(),
                      device)
    launches = sc.launches
    C11, C12, C44 = C[0, 0], C[0, 1], C[3, 3]
    FCa = FC * s.eV_per_Ha / s.A_per_b ** 2
    log(f"[second] P {P:.9f} GPa, H {H:.9f} eV, K {K:.6f} GPa, C11 "
        f"{C11:.6f}, C12 {C12:.6f}, C44 {C44:.6f} GPa, Phi[0, 0] diag "
        f"{np.diag(FCa[0, 0])} eV/A^2; spectral_conv launches {launches}")
    failed = []
    sigma = s.stress("GPa").cpu().numpy()
    p_sig = -np.trace(sigma) / 3.0
    if not abs(P - p_sig) <= 1e-6 * abs(p_sig):
        failed.append(f"P {P} vs -tr(sigma)/3 {p_sig}")
    sym = max(abs(C[0, 0] - C[1, 1]), abs(C[0, 0] - C[2, 2])) / abs(C11)
    sym = max(sym, abs(C[0, 1] - C[0, 2]) / abs(C12),
              abs(C[3, 3] - C[4, 4]) / abs(C44))
    if not sym <= 1e-3:
        failed.append(f"cubic symmetry {sym:.3e}")
    # the kernel at its new site: one CG preconditioner application against
    # its plain version, and the CG iterations of the K solve with each
    M = s._exact_precond_kernel(s._box_vecs, s._N_elec)
    q = torch.randn((n, n, n), dtype=torch.float64, device=device,
                    generator=torch.Generator(device=device).manual_seed(1))
    a = s._cg_precond()(q)
    b = sc.spectral_conv_reference(q, M)
    dq = float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))
    energy = s._volume_energy_fn()
    vol0 = torch.tensor(s.volume("b3"), dtype=torch.float64, device=device)
    implicit.solves.clear()
    _, Hp = implicit.ground_state_hessian(
        energy, s._gs_chi(), vol0,
        precond=lambda v: sc.spectral_conv_reference(v, M))
    its_plain = [k for k, _ in implicit.solves]
    K_plain = float(vol0 * Hp[0, 0]) * GPA
    log(f"[second] CG preconditioner by the kernel vs its plain version: "
        f"max rel diff {dq:.3e} (bound 1e-12); K solve CG iterations "
        f"{kst['iters']} with the kernel, {its_plain} with the plain "
        f"version (bound: within 1); K {K_plain:.9f} GPa with the plain "
        f"version, rel diff {abs(K - K_plain) / abs(K_plain):.3e}")
    if not dq <= 1e-12:
        failed.append(f"CG preconditioner kernel vs plain {dq:.3e}")
    if len(its_plain) != len(kst["iters"]) or any(
            abs(x - y) > 1 for x, y in zip(its_plain, kst["iters"])):
        failed.append(f"CG iterations {kst['iters']} vs plain {its_plain}")
    # finite differences of re-optimized states
    t0 = time.perf_counter()
    eps = 4e-3
    lv0 = s.lattice_vectors("a").cpu().numpy()
    V0 = s.volume("b3")
    den0 = s.density().clone()

    def reopt(lv=None, R=None):
        s2 = build_bench_system((n, n, n), torch.float64, device,
                                cell=lv0 if lv is None else lv)
        if R is not None:
            s2.place_ions(R, units="b")
        s2.set_density(den0 * V0 / s2.volume("b3"))
        _second_optimize(s2)
        return s2
    es = [reopt(lv0 * f ** (1.0 / 3.0)).energy()
          for f in (1 - eps, 1 + eps)]
    E0 = s.energy()
    K_fd = V0 * (es[0] - 2 * E0 + es[1]) / (V0 * eps) ** 2 * GPA
    ss = []
    for f in (1 - eps, 1 + eps):
        strain = np.eye(3)
        strain[0, 0] = f
        ss.append(reopt(lv0 @ strain.T).stress("GPa").cpu().numpy())
    dsig = (ss[1] - ss[0]) / (2 * eps)
    R0 = s.cartesian_ionic_coordinates("b").cpu().numpy()
    Fs = []
    for d in (-1e-3, 1e-3):
        R = R0.copy()
        R[1, 0] += d
        Fs.append(reopt(R=R).forces("Ha/b").cpu().numpy())
    dF = -(Fs[1][0] - Fs[0][0]) / 2e-3
    log(f"[second] finite differences ({time.perf_counter() - t0:.2f} s): "
        f"K {K_fd:.6f} GPa, C11 {dsig[0, 0]:.6f}, C12 {dsig[1, 1]:.6f} "
        f"GPa, -dF_0/dR_1x {dF} Ha/b^2 vs Phi[0, 1][:, 0] {FC[0, 1][:, 0]}")
    for name, a, b in (("K", K, K_fd), ("C11", C11, dsig[0, 0]),
                       ("C12", C12, dsig[1, 1])):
        if not abs(a - b) <= 2e-2 * abs(b):
            failed.append(f"{name} {a} vs finite differences {b}")
    if not np.allclose(FC[0, 1][:, 0], dF, rtol=0, atol=2e-5):
        failed.append(f"Phi[0, 1][:, 0] {FC[0, 1][:, 0]} vs {dF}")
    if launches == 0:
        failed.append("no spectral_conv launch in the getters")
    if failed:
        raise AssertionError(f"[second] {failed}")
    return launches, dict(K=kst, C=cst, FC=fst)


def phase_pme(device, n=128, order=20):
    """The main path's cell at n^3 f64 with pme_order=20 against the exact
    structure factor: E, density, forces and stress at np.allclose's
    defaults (tests/test_particle_mesh_ewald.py::test4); the structure
    factor's time by both routes."""
    import torch
    from professad_tpu_torch.models import ions
    from professad_tpu_torch.ops import spectral_conv as sc
    out = {}
    sc.launches = 0
    for tag, po in (("exact", None), ("pme", order)):
        s = build_bench_system((n, n, n), torch.float64, device,
                               pme_order=po)
        _second_optimize(s, ntol=1e-9)
        out[tag] = (s.energy("eV"), s.density().cpu().numpy(),
                    s.forces().cpu().numpy(), s.stress().cpu().numpy())
    launches = sc.launches
    box = s._box_vecs
    cart = s.cartesian_ionic_coordinates("b")
    shape = (n, n, n)
    t_ex = cuda_time_ms(lambda: ions.structure_factor(box, shape, cart), 5)
    t_pme = cuda_time_ms(lambda: ions.structure_factor_spline(
        box, shape, cart, order), 5)
    ok = [np.allclose(a, b) for a, b in zip(out["exact"], out["pme"])]
    log(f"[pme] {n}^3 f64, order {order}: E {out['pme'][0]:.9f} vs exact "
        f"{out['exact'][0]:.9f} eV; allclose E/density/forces/stress {ok}; "
        f"structure factor exact {t_ex:.3f} ms, PME {t_pme:.3f} ms; "
        f"spectral_conv launches {launches}")
    if not all(ok) or launches == 0:
        raise AssertionError("[pme] PME disagrees with the exact path")
    return launches


def phase_radial(device, sync, E128, n=320):
    """The radial preconditioner kernel at 128^3 and n^3, on the ray of
    ``_cell_precond_kernel`` (n1d = max(4096, 16 max(shape)), the JAX package's
    rule), f64 on the card:
    - equal to the same function on the CPU within 1e-10 of its largest
      value (M spans ~7e4, so rounding in the small F at high |k| reaches
      3e-11 at 320^3);
    - its ratio to the full-grid HVP kernel, divided by its median: printed
      (the JAX package's own kernel is flat only to 9.4e-3 at 128^3,
      ROADMAP C4); at 128^3 on a ray of 16384 points it must be flat within
      1e-5, the bound of tests/test_system_utils.py;
    - the time and peak memory of each kernel;
    - spectral_conv with the radial M at n^3 against its plain version on a
      random field: rel 1e-12 in f64, 5e-6 in f32.
    Then the n^3 main path in f32 and f64, where _precond_kernel must pick
    the radial kernel by itself: each must converge with |E_n - E_128| <
    1e-3 eV/atom.  Returns the f32 main path's launches."""
    import torch
    from professad_tpu_torch.ops import spectral_conv as sc
    failed = []
    cpu = torch.device("cpu")
    for m in (128, n):
        s = build_bench_system((m, m, m), torch.float64, device)
        Ne = float(s._N_elec)
        ray = max(4096, 16 * m)
        rays = [ray] + ([16384] if m == 128 else [])
        kern = {}
        for tag, r, fn in (
                [("full HVP", None, lambda r: s._exact_precond_kernel(
                    s._box_vecs, Ne))]
                + [("radial", r, lambda r: s._exact_precond_kernel_radial(
                    s._box_vecs, Ne, n1d=r)) for r in rays]):
            fn(r)
            sync()
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            kern[r] = fn(r)
            sync()
            mib = torch.cuda.max_memory_allocated(device) / 2**20
            log(f"[radial] {m}^3 f64 {tag} kernel"
                f"{'' if r is None else f' (n1d {r})'}: "
                f"{1e3 * (time.perf_counter() - t0):.2f} ms, max memory "
                f"allocated {mib:.1f} MiB")
        for r in rays:
            q = (kern[None] / kern[r]).cpu().numpy()
            flat = float(np.max(np.abs(q / np.median(q) - 1.0)))
            log(f"[radial] {m}^3, n1d {r}: max |ratio / median - 1| "
                f"{flat:.3e}" + (" (bound 1e-5)" if r == 16384 else ""))
            if r == 16384 and not flat < 1e-5:
                failed.append(f"{m}^3 n1d {r} ratio not flat: {flat:.3e}")
        M = kern[ray]
        del kern
        sh = build_bench_system((m, m, m), torch.float64, cpu)
        Mc = sh._exact_precond_kernel_radial(sh._box_vecs, Ne, n1d=ray)
        d = float(torch.max(torch.abs(M.cpu() - Mc)) / torch.max(Mc))
        log(f"[radial] {m}^3 radial kernel (n1d {ray}), card vs CPU: max "
            f"rel diff {d:.3e} (bound 1e-10)")
        if not d <= 1e-10:
            failed.append(f"{m}^3 radial kernel card vs CPU {d:.3e}")
        del sh, Mc
        if m == n:
            g = torch.Generator(device=device).manual_seed(2)
            for dt, tol in ((torch.float64, 1e-12), (torch.float32, 5e-6)):
                x = torch.randn((m, m, m), dtype=torch.float64, device=device,
                                generator=g).to(dt)
                a = sc.spectral_conv(x, M.to(dt))
                b = sc.spectral_conv_reference(x, M.to(dt))
                e = float(torch.max(torch.abs(a - b))
                          / torch.max(torch.abs(b)))
                log(f"[radial] spectral_conv with the radial M at {m}^3 "
                    f"{str(dt)[6:]}: max rel diff to its plain version "
                    f"{e:.3e} (bound {tol:g})")
                if not e <= tol:
                    failed.append(f"spectral_conv {m}^3 {dt}: {e:.3e}")
        del s, M
    launches = 0
    for dt in (torch.float32, torch.float64):
        s = build_bench_system((n, n, n), dt, device)
        picked = []
        radial = s._exact_precond_kernel_radial

        def spy(*a, **k):
            picked.append(k.get("n1d"))
            return radial(*a, **k)
        s._exact_precond_kernel_radial = spy
        sync()
        sc.launches = 0
        t0 = time.perf_counter()
        n_it, conv = s.optimize_density(
            ntol=NTOL, n_method="TPGD", analytic=True, precondition=True,
            n_step_size=1.0, skip_iters=2, jit_loop=True, from_uniform=True,
            n_maxiter=400)
        sync()
        t = time.perf_counter() - t0
        E = s.energy("eV") / 4
        d = abs(E - E128 / 4)
        log(f"[radial] {n}^3 {str(dt)[6:]} main path: radial kernel picked "
            f"{picked} (n1d), iterations {n_it}, converged {conv}, "
            f"{t:.3f} s, E {E:.9f} eV/atom, |E_{n} - E_128| {d:.3e} eV/atom "
            f"(bound 1e-3), spectral_conv launches {sc.launches}")
        if dt == torch.float32:
            launches = sc.launches
        if not picked:
            failed.append(f"{dt}: the radial kernel was not picked")
        if not conv or not d < 1e-3 or sc.launches < 3 * n_it:
            failed.append(f"the {n}^3 {dt} main path failed")
        del s
    if failed:
        raise AssertionError(f"[radial] {failed}")
    return launches


EOS_N, EOS_F = 9, 0.05
EOS_SOLVE = dict(n_method="TPGD", lr=1.0, ntol=NTOL, conv_count=3,
                 max_iter=1000, analytic=True)
DOCS_EOS = (87.821, 4.2268, -57.231, 16.86)   # tests/test_docs_parity.py


def _eos_fit_points(s, vs, fs, E_ions):
    """(K0 GPa, K0', E0 eV/atom, V0 A^3/atom) of the scan's points, as
    ``System.eos_fit`` forms them."""
    from professad_tpu_torch.utils.elastic import fit_eos
    N = s.ion_count()
    vols = [float(v) / N for v in vs]
    enes = [(float(f) + E) * s.eV_per_Ha / N for f, E in zip(fs, E_ions)]
    params, _ = fit_eos(vols, enes, "bm")
    params[0] *= s.GPa_per_atomic / (s.eV_per_Ha / s.A_per_b ** 3)
    return params


def _eos_scans(device, sync, n):
    """(a) the batched f32 scan and (b) the same per-lane solve 9 times,
    on the main path's cell at n^3, each timed after a warm run; returns
    both fits and the batched run's numbers."""
    import torch
    from professad_tpu_torch.ops import spectral_conv as sc
    s = build_bench_system((n, n, n), torch.float32, device)
    vs = s.volume("a3") * np.linspace(1 - EOS_F, 1 + EOS_F, EOS_N)
    norm = (s.lattice_vectors("a") / s.volume("a3") ** (1 / 3)).cpu().numpy()
    t0 = time.perf_counter()
    box, vext, chi, E_ions = s._eos_points(vs, norm)
    sync()
    t_setup = time.perf_counter() - t0
    batched = s._eos_solve_fn(dtype=torch.float32, **EOS_SOLVE)
    serial = s._eos_solve_fn(batched=False, dtype=torch.float32,
                             **EOS_SOLVE)
    out = {}
    for tag, run in (
            ("batched", lambda c: batched(c, box, vext)),
            ("serial", lambda c: [serial(c[b], box[b], vext[b])
                                  for b in range(EOS_N)])):
        run(chi)                                   # warm run
        sync()
        torch.cuda.reset_peak_memory_stats(device)
        sc.launches = 0
        t0 = time.perf_counter()
        res = run(chi * (1 + 1e-7))
        sync()
        t = time.perf_counter() - t0
        launches = sc.launches
        if tag == "batched":
            fs, conv, its = res
        else:
            fs, conv, its = (list(c) for c in zip(*res))
        mib = torch.cuda.max_memory_allocated(device) / 2**20
        params = _eos_fit_points(s, vs, fs, E_ions)
        log(f"[eos] ({'a' if tag == 'batched' else 'b'}) {tag} f32 scan, "
            f"{EOS_N} volumes +-{EOS_F:.0%} at {n}^3: {t:.3f} s (setup "
            f"{t_setup:.3f} s, f64 on the card), iterations per lane {its}, "
            f"converged {sum(conv)}/{EOS_N}, spectral_conv launches "
            f"{launches}, max memory allocated {mib:.1f} MiB; K0 "
            f"{params[0]:.6f} GPa, K0' {params[1]:.6f}, E0 {params[2]:.9f} "
            f"eV/atom, V0 {params[3]:.9f} A^3/atom")
        if not all(conv):
            raise AssertionError(f"[eos] {tag} scan: a lane did not converge")
        out[tag] = dict(t=t, its=its, launches=launches, params=params,
                        mib=mib)
    want = 3 * max(out["batched"]["its"]) + 2
    log(f"[eos] batched scan launches {out['batched']['launches']} = 3 sites "
        f"(preconditioner, vW, WT) x {max(out['batched']['its'])} iterations "
        f"+ 2 (the first evaluation's vW and WT): {want}, for {EOS_N} lanes; "
        f"the serial scan launched {out['serial']['launches']}")
    if out["batched"]["launches"] != want:
        raise AssertionError("[eos] batched launches scale with the lanes")
    return s, out


def _eos_f64_serial(device, n):
    """(c) System.eos_fit, serial f64, on the main path's cell."""
    import torch
    s = build_bench_system((n, n, n), torch.float64, device)
    t0 = time.perf_counter()
    params, _ = s.eos_fit(f=EOS_F, N=EOS_N, eos="bm", ntol=1e-10,
                          jit_loop=True, precondition=True, n_step_size=1.0)
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    log(f"[eos] (c) serial f64 eos_fit at {n}^3 (L-BFGS, jit_loop, "
        f"preconditioned, ntol 1e-10): {t:.3f} s; K0 {params[0]:.6f} GPa, "
        f"K0' {params[1]:.6f}, E0 {params[2]:.9f} eV/atom, V0 "
        f"{params[3]:.9f} A^3/atom")
    return params, t


def _eos_docs(device):
    """(d) the reference's documentation EOS: fcc Al, vWGTF1 + PBE, 2000
    eV, serial f64 (tests/test_docs_parity.py:28-41)."""
    import torch
    from professad_tpu_torch import System, get_cell
    from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                            vWGTF1, PerdewBurkeErnzerhof)
    lv, frac = get_cell("fcc", vol_per_atom=16.8, device=device)
    shape = System.ecut2shape(2000, lv.cpu().numpy())
    pot = os.path.join(ROOT, "tests", "potentials", "al.gga.recpot")
    s = System(lv, shape, [["Al", pot, frac]],
               [IonIon, IonElectron, Hartree, vWGTF1, PerdewBurkeErnzerhof],
               units="a", coord_type="fractional", device=device,
               dtype=torch.float64)
    t0 = time.perf_counter()
    params, _ = s.eos_fit(f=0.05, N=9, eos="bm", ntol=1e-10, jit_loop=True,
                          precondition=True, n_step_size=1.0)
    t = time.perf_counter() - t0
    K0, K0p, E0, V0 = (float(p) for p in params)
    ok = (abs(K0 - DOCS_EOS[0]) / DOCS_EOS[0] < 0.01
          and abs(K0p - DOCS_EOS[1]) < 0.1 and abs(E0 - DOCS_EOS[2]) < 0.01
          and abs(V0 - DOCS_EOS[3]) / DOCS_EOS[3] < 0.005)
    log(f"[eos] (d) documentation EOS, fcc Al vWGTF1 + PBE at 2000 eV "
        f"{shape}, f64: K0 {K0:.4f} GPa (docs {DOCS_EOS[0]}, 1%), K0' "
        f"{K0p:.4f} ({DOCS_EOS[1]}, 0.1), E0 {E0:.5f} eV/atom "
        f"({DOCS_EOS[2]}, 0.01 eV), V0 {V0:.4f} A^3/atom ({DOCS_EOS[3]}, "
        f"0.5%); {t:.3f} s")
    return ok


EOS_KERNEL_SHAPES = ((EOS_N, 128, 128, 128), (3,) + G2_SHAPE)


def _batched_kernel(device, shapes=EOS_KERNEL_SHAPES):
    """(e) batched spectral_conv against its plain version and, lane by
    lane, against the 3-D call, per-lane and shared K; the first shape
    timed in f32."""
    import torch
    from professad_tpu_torch.ops import spectral_conv as sc
    rng = np.random.default_rng(4)
    failed, timed = [], {}
    for shape in shapes:
        B, n0, n1, n2 = shape
        x_np = rng.standard_normal(shape)
        # the half spectra of real even kernels, K(-k) = K(k): a c2r
        # transform of a spectrum that is not Hermitian is not defined,
        # and cuFFT's batched f32 plan at 128^3 treats one unlike its 3-D
        # plan
        K_np = rng.random(shape)
        K_np = 0.5 * (K_np + K_np[(slice(None),) + np.ix_(
            *[(-np.arange(m)) % m for m in (n0, n1, n2)])])
        K_np = np.ascontiguousarray(K_np[..., : n2 // 2 + 1])
        dts = ((torch.float32, 1e-5), (torch.float64, 1e-12)) \
            if shape == shapes[0] else ((torch.float64, 1e-12),)
        for dt, tol in dts:
            x = torch.tensor(x_np, dtype=dt, device=device)
            for kind in ("per-lane", "shared"):
                K = torch.tensor(K_np if kind == "per-lane" else K_np[0],
                                 dtype=dt, device=device)
                y = sc.spectral_conv(x, K)
                yr = sc.spectral_conv_reference(x, K)
                e_ref = _rel(y, yr)
                e_lane = max(_rel(y[b], sc.spectral_conv(
                    x[b], K if kind == "shared" else K[b]))
                    for b in range(B))
                abs_err = float((y - yr).abs().max())
                log(f"[eos] (e) batched spectral_conv {shape} "
                    f"{str(dt)[6:]} {kind} K: rel to the plain version "
                    f"{e_ref:.3e}, to the 3-D call lane by lane "
                    f"{e_lane:.3e} (tol {tol:g}), max abs {abs_err:.3e}")
                if not (e_ref < tol and e_lane < tol):
                    failed.append(f"{shape} {dt} {kind}")
                if (shape == shapes[0] and dt == torch.float32
                        and kind == "per-lane"):
                    dims = (-3, -2, -1)

                    def lib():
                        return torch.fft.irfftn(
                            K * torch.fft.rfftn(x, dim=dims),
                            s=(n0, n1, n2), dim=dims)
                    with torch.no_grad():
                        ms = cuda_time_ms(lambda: sc.spectral_conv(x, K), 10)
                        gms = graph_time_ms(lambda: sc.spectral_conv(x, K),
                                            10)
                        lms = cuda_time_ms(lib, 10)
                        glms = graph_time_ms(lib, 10)
                    m2 = n2 // 2 + 1
                    bms, by = bound(4 * B * (2 * n0 * n1 * n2 + n0 * n1 * m2),
                                    B * 2 * 2.5 * n0 * n1 * n2
                                    * np.log2(n0 * n1 * n2))
                    timed = dict(ms=ms, graph_ms=gms, library_ms=lms,
                                 library_graph_ms=glms, bound_ms=bms,
                                 bound_by=by, max_abs_err=abs_err)
                    log(f"[eos] (e) batched {shape} f32 per call: kernel "
                        f"{ms:.4f} ms eager, {gms:.4f} ms from a CUDA graph; "
                        f"cuFFT irfftn(K rfftn(x)) over the last three axes "
                        f"{lms:.4f} / {glms:.4f} ms; bound {bms:.4f} ms "
                        f"({by}, {100 * bms / gms:.1f}% of the graph time)")
    if failed:
        raise AssertionError(f"[eos] batched spectral_conv disagrees: "
                             f"{failed}")
    return timed


def _eos_set_device(device, n=32):
    """(f) a System built on the CPU, moved to the card, optimized: the
    energy of one built on the card within 1e-10 relative."""
    import torch
    s = build_bench_system((n, n, n), torch.float64, torch.device("cpu"))
    s.set_device(device)
    optimize(s)
    ref = build_bench_system((n, n, n), torch.float64, device)
    optimize(ref)
    d = abs(s.energy() - ref.energy()) / abs(ref.energy())
    log(f"[eos] (f) set_device: built on the CPU, moved, optimized at {n}^3 "
        f"f64: E {s.energy('eV'):.12f} eV against {ref.energy('eV'):.12f} "
        f"built on the card, rel {d:.3e} (bound 1e-10); density on "
        f"{s.density().device}")
    return d < 1e-10 and s.density().device == device


def _eos_linear_response(device, n=61):
    """(g) get_inv_G on the card, tests/test_linear_response.py's grid."""
    import torch
    from professad_tpu_torch.ops.autodiff import get_inv_G
    from professad_tpu_torch.models import (G_inv_lindhard, WangTeter,
                                            G_inv_gap, KGAP)
    box = 8 * torch.eye(3, dtype=torch.float64, device=device)
    den = torch.ones((n, n, n), dtype=torch.float64, device=device)
    _, G_lind = G_inv_lindhard(box, den)
    _, G_wt = get_inv_G(box, den, WangTeter)
    eta, G_k = get_inv_G(box, den, lambda bv, m: KGAP(bv, m, 1.17))
    _, G_gap = G_inv_gap(box, den, 1.17)
    d_wt = float((G_wt - G_lind).abs().max())
    d_k = float((G_k - G_gap)[eta != 0].abs().max())
    log(f"[eos] (g) get_inv_G at {n}^3 f64 on the card: WT vs Lindhard "
        f"{d_wt:.3e}, KGAP vs gapped jellium {d_k:.3e} (atol 1e-10)")
    return d_wt < 1e-10 and d_k < 1e-10


def phase_eos(device, sync, n=128, kernel_shapes=EOS_KERNEL_SHAPES):
    """The EOS scan (see the module docstring, phase 15).  Returns the
    batched scan's launches and the batched kernel's times."""
    s, scans = _eos_scans(device, sync, n)
    del s
    pa, pb = scans["batched"]["params"], scans["serial"]["params"]
    pc, _ = _eos_f64_serial(device, n)
    checks = {}
    for tag, (x, y, tol) in {
            "(a) vs (b) K0": (pa[0], pb[0], 1e-4),
            "(a) vs (b) V0": (pa[3], pb[3], 1e-4),
            "(a) vs (c) K0": (pa[0], pc[0], 2e-3),
            "(a) vs (c) V0": (pa[3], pc[3], 2e-3)}.items():
        d = abs(x - y) / abs(y)
        log(f"[eos] {tag}: {x:.9f} vs {y:.9f}, rel {d:.3e} (bound {tol:g})")
        checks[tag] = d < tol
    t_a, t_b = scans["batched"]["t"], scans["serial"]["t"]
    log(f"[eos] time to the f32 scan: batched {t_a:.3f} s, serial "
        f"{t_b:.3f} s ({t_b / t_a:.2f}x)")
    checks["(d) documentation numbers"] = _eos_docs(device)
    timed = _batched_kernel(device, kernel_shapes)
    checks["(f) set_device"] = _eos_set_device(device)
    checks["(g) linear response"] = _eos_linear_response(device)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"[eos] failed: {failed}")
    return scans["batched"]["launches"], timed


MESH_SOLVE = dict(ntol=NTOL, n_method="TPGD", analytic=True,
                  precondition=True, n_step_size=1.0, skip_iters=2,
                  jit_loop=True, from_uniform=True, n_maxiter=5000)


def phase_mesh(device, sync, serial, sizes=(128, 64, 32, 64)):
    """The mesh paths on one NCCL rank (module docstring, phase 16);
    ``serial`` is the [slice] result of this call at ``sizes[0]``; the
    other sizes are those of (b), (c) and (d).  Returns spectral_conv's
    launches in the timed mesh run (0: the pencil path composes torch.fft
    transforms)."""
    import tempfile
    import torch
    import torch.distributed as dist
    from professad_tpu_torch.ops import spectral_conv as sc
    from professad_tpu_torch.parallel import init_process_group, make_mesh
    checks = {}
    with tempfile.TemporaryDirectory() as tmp:
        init_process_group(0, 1, "file://" + os.path.join(tmp, "rdv"),
                           device=device)
        try:
            nccl = ".".join(map(str, torch.cuda.nccl.version()))
            log(f"[mesh] NCCL {nccl}, backend {dist.get_backend()}, world "
                f"size {dist.get_world_size()}")
            mesh = make_mesh(1)
            n = sizes[0]
            s = build_bench_system((n, n, n), torch.float32, device)
            s.optimize_density(mesh=mesh, **MESH_SOLVE)     # warm run
            sync()
            torch.cuda.reset_peak_memory_stats(device)
            sc.launches = 0
            t0 = time.perf_counter()
            n_it, conv = s.optimize_density(mesh=mesh, **MESH_SOLVE)
            sync()
            t = time.perf_counter() - t0
            launches = sc.launches
            mib = torch.cuda.max_memory_allocated(device) / 2**20
            E = s.energy("eV")
            dE = abs(E - serial["E"]) / 4
            log(f"[mesh] (a) {n}^3 f32 optimize_density(mesh=make_mesh(1)): "
                f"iterations {n_it}, converged {conv}, E {E:.9f} eV, time to "
                f"converge {t:.4f} s, {1e3 * t / max(n_it, 1):.3f} ms/iter, "
                f"max memory allocated {mib:.1f} MiB, spectral_conv "
                f"launches {launches}; serial [slice]: iterations "
                f"{serial['n_it']}, {serial['t']:.4f} s, "
                f"{1e3 * serial['t'] / max(serial['n_it'], 1):.3f} ms/iter "
                f"(mesh / serial {t / serial['t']:.2f}x); |dE| {dE:.3e} "
                f"eV/atom (bound 2e-5)")
            checks["(a) converged"] = bool(conv)
            checks["(a) energy"] = dE < 2e-5
            checks["(a) iterations"] = abs(n_it - serial["n_it"]) <= 2
            checks["(a) no spectral_conv launch"] = launches == 0
            del s

            n = sizes[1]
            # off equilibrium (a stress well above the terms' cancellation)
            # and with a displaced ion (forces)
            geo = dict(cell=0.97 * 4.050 * SHEAR,
                       frac=FCC + np.array([[0.01, 0.02, 0.0], [0, 0, 0],
                                            [0, 0, 0], [0, 0, 0]]))
            kw = dict(MESH_SOLVE, ntol=1e-10)
            ser = build_bench_system((n, n, n), torch.float64, device,
                                     **geo)
            ser.optimize_density(**kw)
            msh = build_bench_system((n, n, n), torch.float64, device,
                                     **geo)
            msh.optimize_density(mesh=mesh, **kw)
            # forces and stress depend on the density at first order: the
            # serial ones at the mesh's density
            at = build_bench_system((n, n, n), torch.float64, device,
                                    **geo)
            at.set_density(msh.density())
            rels = {"E": abs(msh.energy() - ser.energy()) / abs(ser.energy()),
                    "forces": _rel(msh.forces(), at.forces()),
                    "stress": _rel(msh.stress(), at.stress())}
            log(f"[mesh] (b) {n}^3 f64, the G1 cell compressed 3%, ion 0 "
                f"displaced, mesh vs serial: "
                f"E of the two solves, forces and stress at the mesh "
                f"solve's density: " + ", ".join(
                    f"{k} rel {v:.3e}" for k, v in rels.items())
                + f" (bound 1e-12); max |F| "
                f"{float(at.forces().abs().max()):.3e} Ha/bohr, max |sigma| "
                f"{float(at.stress().abs().max()):.3e} Ha/bohr^3")
            checks["(b) E, forces, stress"] = max(rels.values()) < 1e-12
            del ser, msh, at

            n = sizes[2]
            s = build_bench_system((n, n, n), torch.float64, device)
            s.optimize_density(**dict(MESH_SOLVE, ntol=1e-10))
            t0 = time.perf_counter()
            K_ser = s.bulk_modulus("GPa")
            t_ser = time.perf_counter() - t0
            s.set_mesh(mesh)
            t0 = time.perf_counter()
            K_msh = s.bulk_modulus("GPa")
            t_msh = time.perf_counter() - t0
            rel = abs(K_msh - K_ser) / abs(K_ser)
            log(f"[mesh] (c) {n}^3 f64 bulk modulus: mesh {K_msh:.9f} GPa "
                f"({t_msh:.3f} s), serial {K_ser:.9f} GPa ({t_ser:.3f} s), "
                f"rel {rel:.3e} (bound 1e-10)")
            checks["(c) bulk modulus"] = rel < 1e-10
            del s

            n = sizes[3]
            kw = dict(f=EOS_F, N=EOS_N, n_method="TPGD", n_step_size=1.0,
                      ntol=NTOL, analytic=True, batched=True,
                      dtype=torch.float32)
            bmesh = make_mesh(1, batch=1)
            t0 = time.perf_counter()
            pm, _ = build_bench_system((n, n, n), torch.float64,
                                       device).eos_fit(mesh=bmesh, **kw)
            t_m = time.perf_counter() - t0
            t0 = time.perf_counter()
            ps, _ = build_bench_system((n, n, n), torch.float64,
                                       device).eos_fit(**kw)
            t_s = time.perf_counter() - t0
            dK, dV = (abs(pm[i] - ps[i]) / abs(ps[i]) for i in (0, 3))
            log(f"[mesh] (d) {n}^3 f32 batched eos_fit on a batch mesh: K0 "
                f"{pm[0]:.6f} GPa, V0 {pm[3]:.9f} A^3/atom ({t_m:.3f} s); "
                f"serial batched K0 {ps[0]:.6f}, V0 {ps[3]:.9f} "
                f"({t_s:.3f} s); rel {dK:.3e}, {dV:.3e} (bound 1e-4)")
            checks["(d) eos_fit on a batch mesh"] = dK < 1e-4 and dV < 1e-4
        finally:
            dist.destroy_process_group()
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"[mesh] failed: {failed}")
    return launches


EXAMPLES = ("torch_density_optimization", "torch_geometry_optimization",
            "torch_parameterized_functionals")


def _example(name, device, card):
    """Run examples/<name>.py's main() on the card (its default device);
    returns its numbers and logs its seconds, launches and peak memory."""
    import importlib
    import torch
    from professad_tpu_torch.ops import spectral_conv as sc
    path = os.path.join(ROOT, "examples")
    if path not in sys.path:
        sys.path.insert(0, path)
    ex = importlib.import_module(name)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    before = sc.launches
    t0 = time.perf_counter()
    out = ex.main()
    torch.cuda.synchronize(device)
    t = time.perf_counter() - t0
    launches = sc.launches - before
    mib = torch.cuda.max_memory_allocated(device) / 2**20
    log(f"[examples] {name}: {t:.2f} s, spectral_conv launches {launches}, "
        f"max memory allocated {mib:.1f} MiB ({card})")
    return out


def phase_examples(device, card):
    """The example workflows (module docstring, phase 17).  Returns
    spectral_conv's launches in the phase."""
    from professad_tpu_torch.ops import spectral_conv as sc
    sc.launches = 0
    den, geo, train = (_example(name, device, card) for name in EXAMPLES)
    launches = sc.launches
    checks = {}
    paths = [den[k] for k in ("host", "jit_loop", "tpgd", "analytic")]
    energies = [p["E"] for p in paths]
    spread = max(energies) - min(energies)
    a = den["analytic"]
    log(f"[examples] density {den['shape']}: energies "
        f"{', '.join(f'{e:.10f}' for e in energies)} eV (spread "
        f"{spread:.3e}, bound 1e-6); analytic TPGD {a['n_it']} iterations, "
        f"{a['launches']} launches (bound >= 3 x iterations)")
    checks["density: every path converged"] = all(p["conv"] for p in paths)
    checks["density: paths agree"] = spread < 1e-6
    checks["density: analytic launches"] = a["launches"] >= 3 * a["n_it"]
    cell, hcp = geo["cell"], geo["hcp"]
    offset = (cell["frac"][1] - cell["frac"][0]) % 1.0
    log(f"[examples] geometry: bcc Li ions + cell converged "
        f"{cell['converged']}, max |F| {cell['max_force']:.3e} eV/A, max "
        f"|sigma| {cell['max_stress']:.3e} eV/A^3, ion offset {offset}; "
        f"hcp converged {hcp['converged']}, a {hcp['a']:.4f} bohr, c/a "
        f"{hcp['c_over_a']:.4f}")
    checks["geometry: bcc Li converged"] = bool(cell["converged"])
    checks["geometry: hcp converged"] = bool(hcp["converged"])
    checks["geometry: bcc Li in the bounds of tests/test_geometry.py"] = (
        cell["max_force"] < 0.02 and cell["max_stress"] < 0.003
        and bool(np.allclose(offset, 0.5, atol=5e-3)))
    gs = train["gs_losses"]
    log(f"[examples] training: Pauli-Gaussian loss {train['pg_losses'][0]:.4e}"
        f" -> {train['pg_losses'][-1]:.4e}, neural {train['nn_losses'][0]:.4e}"
        f" -> {train['nn_losses'][-1]:.4e}, checkpoint bit-exact "
        f"{train['checkpoint_ok']}, ground-state losses "
        f"{', '.join(f'{v:.4e}' for v in gs)}")
    for key in ("pg_losses", "nn_losses"):
        checks[f"training: {key} fall"] = train[key][-1] < train[key][0]
    checks["training: checkpoint round trip"] = bool(train["checkpoint_ok"])
    checks["training: ground-state loss not above its start"] = gs[-1] <= gs[0]
    log(f"[examples] spectral_conv launches {launches}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"[examples] failed: {failed}")
    return launches


PAIR_CONFIGS = (("al2048", "al-fcc-2048-wt-pbe-f64.json"),
                ("mg96", "mg-hcp-96-wtexp-pbe-f64.json"))


def _pair_case(conf, device):
    """(h, R, Z, shifts, Rc, Rd) [bohr] of a benchmark configuration's
    supercell on ``device``, the ions displaced by a seeded 0.10 A
    Gaussian a component; Rc six heights and a hair, Rd as System takes
    it."""
    import torch
    from professad_tpu_torch.models import ions
    from harness.spec import (A_PER_BOHR, ideal_cell, ion_ion_rc_bohr,
                              recpot_path)
    box_A, frac = ideal_cell(conf)
    cart_A = frac @ box_A + 0.1 * np.random.default_rng(11).standard_normal(
        frac.shape)
    box = box_A / A_PER_BOHR
    h_max = float(np.max(1.0 / np.sqrt(np.sum(np.linalg.inv(box.T) ** 2,
                                               axis=1))))
    Rc = ion_ion_rc_bohr(conf) * (1.0 + 1e-9)
    Rd = float(np.sqrt(h_max * Rc / 3.0))
    t = dict(dtype=torch.float64, device=device)
    Z = float(ions.get_ion_charge(recpot_path(conf)))
    return (torch.tensor(box, **t), torch.tensor(cart_A / A_PER_BOHR, **t),
            torch.full((len(frac),), Z, **t),
            torch.tensor(ions.neighbor_shifts(box, Rc), **t), Rc, Rd)


def phase_pairs(device, configs=PAIR_CONFIGS):
    """The ion-ion pair kernel against its torch form at the benchmark's
    shapes (module docstring, phase 18); ``configs`` are (tag, file under
    benchmark/configs).  Returns the first case's numbers for the kernels
    line."""
    import torch
    bench = os.path.join(ROOT, "benchmark")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    from harness.pair_roofline import (ENERGY_FLOPS_PER_PAIR,
                                       FORCE_FLOPS_PER_PAIR, pairs_within)
    from harness.roofline import PEAKS
    from harness.spec import load_json
    from professad_tpu_torch.models import ions
    from professad_tpu_torch.ops.grid import volume
    out, failed = {}, []
    for tag, name in configs:
        conf = load_json(os.path.join(bench, "configs", name))
        h, R, Z, sh, Rc, Rd = _pair_case(conf, device)
        n = R.shape[0]
        chunk = max(1, ions._MAX_PAIRS // (n * n))
        Rg, hg = R.clone().requires_grad_(True), h.clone().requires_grad_(True)
        P, Q, _, _ = ions._IonPairSum.apply(Rg, hg, Z, sh, Rc, Rd, chunk,
                                            True, True)
        gR, gh = torch.autograd.grad(P, (Rg, hg))
        P0, Q0 = ions._pair_energy_torch(R, h, Z, sh, Rc, Rd, chunk)
        gR0, gh0 = ions._pair_grads_torch(R, h, Z, sh, Rc, Rd, chunk)
        e_rel = abs(float(P.detach() - P0)) / abs(float(P0))
        q_gap = float((Q - Q0).abs().max())
        f_gap = 0.5 * float((gR - gR0).abs().max())
        h_rel = float((gh - gh0).abs().max() / gh0.abs().max())
        ms = cuda_time_ms(lambda: ions._pair_sum_cuda(
            R, h, Z, sh, Rc, Rd, False), 3)
        grad_ms = cuda_time_ms(lambda: ions._pair_sum_cuda(
            R, h, Z, sh, Rc, Rd, True), 3)
        plain_ms = cuda_time_ms(lambda: ions._pair_energy_torch(
            R, h, Z, sh, Rc, Rd, chunk), 1)
        plain_grad_ms = cuda_time_ms(lambda: ions._pair_grads_torch(
            R, h, Z, sh, Rc, Rd, chunk), 1)
        pairs = pairs_within(n, Rc, float(volume(h)))
        bound_ms = 1e3 * pairs * ENERGY_FLOPS_PER_PAIR / PEAKS["fp64_flops"]
        grad_bound_ms = 1e3 * pairs * FORCE_FLOPS_PER_PAIR \
            / PEAKS["fp64_flops"]
        log(f"[pairs] {tag}: {n} ions, {sh.shape[0]} images, {pairs:.4e} "
            f"pairs within Rc {Rc:.4f} bohr; pair energy rel {e_rel:.3e} "
            f"(bound 1e-12), Q max gap {q_gap} (exact), dE/dR max gap "
            f"{f_gap:.3e} Ha/bohr (bound 1e-10), dE/dh rel {h_rel:.3e} "
            f"(bound 1e-10); kernel {ms:.3f} ms, with gradients "
            f"{grad_ms:.3f} ms (bounds {bound_ms:.3f}, {grad_bound_ms:.3f}); "
            f"torch form {plain_ms:.1f} / {plain_grad_ms:.1f} ms")
        if not (e_rel <= 1e-12 and q_gap == 0 and f_gap <= 1e-10
                and h_rel <= 1e-10):
            failed.append(tag)
        out[tag] = dict(max_abs_err=f_gap, ms=ms, grad_ms=grad_ms,
                        plain_ms=plain_ms, plain_grad_ms=plain_grad_ms,
                        bound_ms=bound_ms, grad_bound_ms=grad_bound_ms)
        del Rg, hg, P, Q, gR, gh, gR0, gh0
    if failed:
        raise AssertionError(f"[pairs] kernel and torch form disagree: "
                             f"{failed}")
    return out[configs[0][0]]


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs the GPU",
              file=sys.stderr)
        return 1
    from professad_tpu_torch.models import ions
    from professad_tpu_torch.ops import spectral_conv as sc
    from professad_tpu_torch.ops import vpufft as vf

    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    device = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    t_start = t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(sc.build_library), pool.submit(vf.build_library)]
        for b in builds:
            b.result()
    log(f"[build] spectral_conv.cu and stockham.cu built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    kern = phase_kernel(device)
    stock = phase_stockham(device)
    bfly_launches = phase_bfly(device)
    ions.pair_launches = 0
    s32, res = phase_slice(device, 128, sync)
    phase_derivatives(s32)
    pair_launches = ions.pair_launches
    log(f"[slice] ion-ion pair kernel launches {pair_launches} (set-up, "
        "optimisation, forces, stress)")
    if pair_launches == 0:
        raise AssertionError("the main path never launched the pair kernel")
    del s32
    phase_f64(device, 128, res["E"], sync)
    phase_golden(device)
    phase_fd_forces(device)
    geo_launches, _, _ = phase_geometry(device, sync)
    nl_launches, _ = phase_nonlocal(device, sync)
    second_launches, _ = phase_second(device)
    pme_launches = phase_pme(device)
    radial_launches = phase_radial(device, sync, res["E"])
    eos_launches, batched = phase_eos(device, sync)
    mesh_launches = phase_mesh(device, sync, res)
    examples_launches = phase_examples(device, card)
    pairs = phase_pairs(device)

    abs_err, _, ms, pms, lms, graph = kern[(128, 128, 128), torch.float32]
    n = 128
    bms, by = bound(4 * (2 * n ** 3 + n * n * (n // 2 + 1)),
                    2 * 2.5 * n ** 3 * np.log2(n ** 3))
    kernels = [{
        "name": "spectral_conv", "route": "cuda",
        "source": "professad_tpu_torch/csrc/spectral_conv.cu",
        "replaces": "professad_tpu/ops/pallas_fft.py:229",
        "launches": res["launches"], "max_abs_err": abs_err,
        "ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
        "library_ms": lms, "lib_ms": lms,
        "geometry_launches": geo_launches,
        "nonlocal_launches": nl_launches,
        "second_launches": second_launches, "pme_launches": pme_launches,
        "radial_launches": radial_launches, "eos_launches": eos_launches,
        "mesh_launches": mesh_launches,
        "examples_launches": examples_launches,
        "batched_ms": batched["ms"], "batched_graph_ms": batched["graph_ms"],
        "batched_library_ms": batched["library_ms"],
        "batched_library_graph_ms": batched["library_graph_ms"],
        "batched_bound_ms": batched["bound_ms"],
        "batched_max_abs_err": batched["max_abs_err"],
        "library_call": "irfftn(K * rfftn(x)): three calls",
        "graph_ms": graph[0], "plain_graph_ms": graph[1],
        "library_graph_ms": graph[2]}]
    for name, replaces in STOCKHAM.items():
        st = stock[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "professad_tpu_torch/csrc/stockham.cu",
            "replaces": replaces, "launches": bfly_launches[name],
            "max_abs_err": st["max_abs_err"], "ms": st["ms"],
            "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"], "library_ms": st["library_ms"],
            "lib_ms": st["library_ms"], "graph_ms": st["graph_ms"],
            "library_graph_ms": st["library_graph_ms"]})
    kernels.append({
        "name": "ion_pair_sum", "route": "cuda",
        "source": "professad_tpu_torch/csrc/ion_pairs.cu",
        "replaces": "professad_tpu/models/ions.py ion_interaction_sum "
                    "(XLA; no Pallas kernel)",
        "launches": pair_launches, "bound_by": "operations", **pairs})
    log(f"[total] every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
