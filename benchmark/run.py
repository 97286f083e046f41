#!/usr/bin/env python3
"""Run one cell of the benchmark of ``professad_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (import, CUDA context, the System of the cell's configuration, the
kernel build on a checkout's first run, one warm request) is timed as
``setup_s``; then one client sends requests in a closed loop until
``--seconds`` have passed, and the request in flight is finished and
counted.  With ``--trace 0`` the last line of standard output holds the
cell's end-to-end metrics (a ``device_trace`` one from the device
activity of the whole window, recorded in sessions of a few requests);
with ``--trace 1`` its per-layer metrics, read from spans around the
public calls and from a profiler trace of the first requests.  After the window the plain reference judges a sample of the
answers, drawn from the seed, and ``correct`` says whether every number
compared is within its limit.  Needs a CUDA device: without one it exits
with 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# build and kernel caches at fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "professad_tpu")
PROFILED_REQUESTS = {"ground_state": 2, "eos_fit": 1}
# requests per profiler session where an end-to-end metric is read from
# the device's activity over the whole window
DEVICE_CLOCK_REQUESTS = 8


def forbidden_modules(modules=None):
    """Modules whose whole top-level name is a forbidden one (the port's
    own name begins with the JAX package's, so no prefix match)."""
    mods = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in mods} & set(FORBIDDEN))


def card_info(device):
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}, "none"
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = "unknown"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}, limit


def load_reader(name):
    """``metrics/<name>.py``, or for a split metric such as
    ``forces_ms.gs`` the reader of its stem, ``metrics/forces_ms.py``."""
    for stem in (name, name.split(".")[0]):
        path = BENCH / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"bench_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r}")


def judged_requests(kind, seed, served=None):
    """The sample of requests the judge compares, drawn from the seed: a
    ground-state run keeps the densities of request 0 and of one of
    requests 1-5 (where the window reaches it); an EOS run judges one of
    the answers it ``served``."""
    import numpy as np
    pick = np.random.default_rng([int(seed) % (1 << 63), 3])
    if kind == "ground_state":
        return {0, int(pick.integers(1, 6))}
    return {int(pick.integers(0, served))} if served else set()


def run_cell(cell, seed, seconds, trace, device, t_start=None, log=None):
    """One run of ``cell``; returns the result dict (without the module
    check, which the caller makes last)."""
    import numpy as np
    import torch
    from harness.program import Server, build_system
    from harness.spans import Spans
    from harness.traffic import Requests
    from harness import judge
    from professad_tpu_torch.ops import spectral_conv as sc

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    t_start = T_START if t_start is None else t_start
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    config, mix = cell.config, cell.traffic
    kind = mix["request"]
    reqs = Requests(mix, config, seed)
    spans = Spans(sync, on=bool(trace))
    system = build_system(config, device)
    server = Server(system, config, mix, spans)

    # warm-up: every shape this cell's requests use, counted as set-up
    warm_rng = np.random.default_rng([int(seed) % (1 << 63), 2])
    spans.start_request()
    if kind == "eos_fit":
        server.eos(config["c_over_a"])
    elif mix["start"] == "warm":
        server.ground_state(reqs.initial(), from_uniform=True)
    else:
        box = reqs.box
        cart = reqs.frac0 @ box + 0.1 * warm_rng.standard_normal(
            reqs.frac0.shape)
        server.ground_state(cart, from_uniform=True, max_iter=8)
    spans.requests.clear()
    sync()

    keep = judged_requests(kind, seed)
    n_prof = PROFILED_REQUESTS[kind] if trace else 0
    prof = None
    clock = None
    if cuda and not trace and any(m["source"] == "device_trace"
                                  for m in cell.end_to_end):
        from harness.trace import DeviceClock
        clock = DeviceClock(DEVICE_CLOCK_REQUESTS)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    answers, kept, errors, req_s = [], [], [], []
    attempted = failed = 0
    launches0 = sc.launches
    t0 = time.perf_counter()
    if clock is not None:
        clock.start()
    while attempted == 0 or time.perf_counter() - t0 < seconds:
        i = attempted
        req = reqs.next()
        if i == 0 and n_prof:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        spans.start_request()
        attempted += 1
        t_req = time.perf_counter()
        try:
            with torch.profiler.record_function("bench_request"):
                if kind == "eos_fit":
                    ans = server.eos(req["c_over_a"])
                else:
                    ans = server.ground_state(
                        req["cart_A"], from_uniform=mix["start"] != "warm",
                        keep=i in keep)
                    ans["cart_A"] = req["cart_A"]
        except (RuntimeError, ValueError) as exc:
            sync()
            failed += 1
            errors.append(f"request {i}: {type(exc).__name__}: {exc}")
            ans = None
        else:
            answers.append(ans)
            if not ans["converged"]:
                failed += 1
            if kind == "eos_fit" or i in keep:
                kept.append(ans)
        req_s.append(time.perf_counter() - t_req)
        if clock is not None:
            clock.request_done()
        if prof is not None and i == n_prof - 1:
            sync()
            prof.stop()
            sc_calls = sc.launches - launches0
    device_busy_s = clock.close() if clock is not None else None
    window_s = time.perf_counter() - t0
    if prof is not None and attempted < n_prof:
        prof.stop()
        sc_calls = sc.launches - launches0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    device_info, power_limit = card_info(device)
    device_info["memory_peak_bytes"] = int(peak)
    completed = attempted - failed
    for e in errors:
        log(e)
    if clock is not None:
        log(f"[{cell.name}] device clock: {len(clock.sessions)} sessions, "
            f"{sum(t for _, _, t in clock.sessions):.4f} s in the tracer; "
            "(requests, busy s, tracer s) " + json.dumps(clock.sessions))
    times = sorted(req_s)
    log(f"[{cell.name}] seed {seed}: {attempted} requests, {failed} failed, "
        f"window {window_s:.4f} s, set-up {setup_s:.4f} s, peak "
        f"{peak / 2**30:.4f} GiB; card {device_info['kind']}, power limit "
        f"{power_limit}"
        f"; request s median {times[len(times) // 2]:.4f}, max "
        f"{times[-1]:.4f}; {completed / window_s:.6f} completed/s"
        + ("" if device_busy_s is None else
           f"; device busy {device_busy_s:.6f} s"))

    metrics = {}
    if not trace:
        values = {
            "setup_s": setup_s,
            "gs_per_s": completed / window_s,
            "eos_fits_per_min": 60.0 * completed / window_s,
            "peak_mem_gib": peak / 2 ** 30,
        }
        if device_busy_s is not None and completed:
            values["gs_device_ms"] = 1e3 * device_busy_s / completed
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    breakdown = None
    if trace:
        from harness.trace import Trace
        tr = None
        if prof is not None:
            events = prof.profiler.kineto_results.events()
            req_ev = [e for e in events if e.name() == "bench_request"]
            tr = Trace(events, min(e.start_ns() for e in req_ev),
                       max(e.start_ns() + e.duration_ns() for e in req_ev))
            device_info["busy_s"] = tr.busy_s
            device_info["window_s"] = tr.window_s
            breakdown = {"device_ops": tr.top_ops(), "idle_gaps":
                         tr.idle_gaps()}
        skip = set(range(n_prof)) if len(spans.requests) > n_prof else set()
        ctx = SimpleNamespace(
            spans=spans, skip=skip, answers=answers, trace=tr,
            completed=completed, loop_s=window_s,
            spectral_conv_calls=sc_calls if prof is not None else 0,
            n_profiled=min(n_prof, attempted),
            shape=tuple(config["grid"]),
            lanes=mix.get("N", 1) if kind == "eos_fit" else 1,
            itemsize=4 if config["dtype"] == "float32" else 8)
        for m in cell.per_layer:
            v = load_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        log(f"[{cell.name}] per-layer metrics measured on "
            f"{device_info['kind']} at power limit {power_limit}: "
            + ", ".join(f"{k} {v['value']}" for k, v in metrics.items()))

    # the judge, after the window, the peak read and the program freed
    del server, system
    if cuda:
        torch.cuda.empty_cache()
    if kind == "eos_fit":
        # one EOS answer, drawn from the seed among those the window served
        j = judged_requests(kind, seed, len(kept))
        kept = [kept[min(j)]] if kept else []
    nums = judge.numbers(kind, config, mix, kept, device)
    correct, checks = judge.verdict(nums, cell.limits)
    if not kept:
        correct = False
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness.spec import Cell
    cell = Cell(args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"run.py: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    # one intra-op thread: the program is bound by its host dispatch, and
    # more threads only contend with it for the host's cores
    torch.set_num_threads(1)
    result = run_cell(cell, args.seed, args.seconds, args.trace,
                      torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"run.py: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, (v, lim) in result["checks"].items():
        print(f"check {name}: {v} (limit {lim})", file=sys.stderr)
    print(f"check correct: {result['correct']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
