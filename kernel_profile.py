#!/usr/bin/env python3
"""Per-launch device times of the port's hand kernels on one GPU.

    python3 kernel_profile.py

Prints, for spectral_conv at 128^3 and 256^3 (f32 and f64), the device time
of each of its launches under torch.profiler beside the bare cuFFT
composition irfftn(K rfftn(x)); and a profile of one timed run of the 128^3
f32 main path of chip_smoke.py (after a warm run): device time, wall time
under the profiler, the device's busy share, spectral_conv's share of the
device time and the kernel launches.  The first line names the card (nvidia-smi
name and power limit).  Needs a CUDA device.
"""

import subprocess
import sys
import time

import numpy as np


def main():
    import torch
    if not torch.cuda.is_available():
        print("kernel_profile: needs a CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile
    from professad_tpu_torch.ops import spectral_conv as sc
    from chip_smoke import build_bench_system, cuda_time_ms, optimize

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"[card] {card}")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    for n in (128, 256):
        shape = (n, n, n)
        for dt in (torch.float32, torch.float64):
            x = torch.tensor(rng.standard_normal(shape), dtype=dt,
                             device=dev)
            K = torch.tensor(rng.random((n, n, n // 2 + 1)), dtype=dt,
                             device=dev)
            for name, fn in (("spectral_conv",
                              lambda: sc.spectral_conv(x, K)),
                             ("cuFFT", lambda: torch.fft.irfftn(
                                 K * torch.fft.rfftn(x), s=shape))):
                ms = cuda_time_ms(fn, 20)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        fn()
                    torch.cuda.synchronize()
                rows = sorted(
                    ((e.key, e.device_time_total / 10 / 1e3, e.count // 10)
                     for e in prof.key_averages()
                     if e.device_time_total > 0),
                    key=lambda r: -r[1])
                parts = "; ".join(f"{k[:60]} x{c} {t:.4f}"
                                  for k, t, c in rows[:8])
                print(f"[profile] {name} {n}^3 {str(dt)[6:]}: {ms:.4f} ms "
                      f"per call (events); per kernel, ms per call: {parts}")

    s = build_bench_system((128, 128, 128), torch.float32, dev)
    optimize(s)                                    # warm run
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n_it, conv = optimize(s)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in ev) / 1e3
    sc_ms = sum(e.self_device_time_total for e in ev
                if "namespace)::" in e.key) / 1e3
    launches = sum(e.count for e in prof.key_averages()
                   if e.key == "cudaLaunchKernel")
    print(f"[main path] 128^3 f32 under the profiler: {n_it} iterations, "
          f"converged {conv}; wall {1e3 * wall:.1f} ms, device "
          f"{dev_ms:.1f} ms (busy {100 * dev_ms / (1e3 * wall):.1f}%), "
          f"spectral_conv kernels {sc_ms:.1f} ms "
          f"({100 * sc_ms / dev_ms:.1f}% of device time), "
          f"{launches} cudaLaunchKernel calls")
    return 0


if __name__ == "__main__":
    sys.exit(main())
