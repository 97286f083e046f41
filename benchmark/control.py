#!/usr/bin/env python3
"""The readings that a cell's limits are set from: the program's numbers
on many seeds, and the control's on a few, in one process.

    python3 benchmark/control.py --workload <cell> --program-seeds 12 \
        --control-seeds 3 [--out chiprun_out/readings_<cell>.json]

For each program seed it serves the requests a run of that seed would
judge (the same sample, drawn from the seed) through the public System and
judges them as ``run.py`` does.  The control is the plain reference put in
the program's place, in the nearest precision below the configuration's
(``CONTROL_PRECISION``): float32 arithmetic for a float64 configuration;
for a float32 one, float32 arithmetic with every field stored in bfloat16
(``reference.ofdft.to_bf16``).  Its ground states (or EOS scans) and its
energies and forces are worked out so, and judged by the same
comparison.  The benchmark's own runs never run this.  Needs a CUDA
device; ``benchmark/tests`` drives the same functions on the CPU at a
small size.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
# the configuration's dtype -> the control's (arithmetic dtype, storage)
CONTROL_PRECISION = {"float64": ("float32", "identity"),
                     "float32": ("float32", "to_bf16")}
# the bfloat16 solve stalls above its stopping rule: its answer is the
# iterate it has after this many steps
CONTROL_MAX_ITER = 1000
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def program_readings(cell, seed, device):
    """The judged numbers of the program's answers for ``seed``."""
    from harness import judge
    from harness.program import Server, build_system
    from harness.spans import Spans
    from harness.traffic import Requests
    from run import judged_requests
    config, mix = cell.config, cell.traffic
    kind = mix["request"]
    reqs = Requests(mix, config, seed)
    server = Server(build_system(config, device), config, mix,
                    Spans(lambda: None))
    keep = judged_requests(kind, seed, served=3)
    if kind == "ground_state" and mix["start"] == "warm":
        server.ground_state(reqs.initial(), from_uniform=True)
    kept = []
    for i in range(max(keep) + 1):
        req = reqs.next()
        if kind == "eos_fit":
            ans = server.eos(req["c_over_a"])
        else:
            ans = server.ground_state(req["cart_A"],
                                      from_uniform=mix["start"] != "warm",
                                      keep=i in keep)
            ans["cart_A"] = req["cart_A"]
        if i in keep:
            kept.append(ans)
    del server
    return judge.numbers(kind, config, mix, kept, device)


def control_answer(cell, seed, device):
    """The control's answer to the first request of ``seed``."""
    import numpy as np
    import torch
    from harness import judge
    from harness.spec import A_PER_BOHR, ion_ion_rc_bohr, ntol_eV
    from harness.traffic import Requests
    from reference import ofdft as R
    config, mix = cell.config, cell.traffic
    req = Requests(mix, config, seed).next()
    dt_name, quant_name = CONTROL_PRECISION[config["dtype"]]
    f32, quant = getattr(torch, dt_name), getattr(R, quant_name)
    if mix["request"] == "eos_fit":
        ref = judge.eos_reference(config, mix, req["c_over_a"], device,
                                  dtype=f32, quant=quant,
                                  max_iter=CONTROL_MAX_ITER)
        return {"c_over_a": req["c_over_a"], "table": ref["table"],
                "params": ref["params"]}
    box_A, frac0, table, charges = judge._setup(config, device)
    shape = tuple(config["grid"])
    box = torch.tensor(box_A / A_PER_BOHR, dtype=torch.float64,
                       device=device)
    cart = torch.tensor(np.asarray(req["cart_A"]) / A_PER_BOHR,
                        dtype=torch.float64, device=device)
    frac = cart @ torch.linalg.inv(box)
    vext = R.v_ext(box, shape, R.structure_factor(frac, shape), table)
    n_ions = frac0.shape[0]
    den, E, _, _ = R.ground_state(
        config["terms"], box, vext, float(table[2] * n_ions), dtype=f32,
        quant=quant, ntol=ntol_eV(config, n_ions) / R.EV_PER_HA,
        max_iter=CONTROL_MAX_ITER)
    den32 = quant(den.to(f32))
    F = R.electron_ion_forces(box.to(f32), den32, frac.to(f32), table,
                              quant=quant).to(torch.float64)
    E = E.to(torch.float64)
    if "IonIon" in config["terms"]:
        E_ii, F_ii = R.ion_ion(box, frac @ box, charges,
                               ion_ion_rc_bohr(config), forces=True)
        E, F = E + E_ii, F + F_ii
    return {"cart_A": req["cart_A"], "E_eV": float(E) * R.EV_PER_HA,
            "F_eV_A": F.cpu().numpy() * R.EV_PER_HA / A_PER_BOHR,
            "density": den32.to(torch.float64)}


def readings(cell, program_seeds, control_seeds, device, log=print):
    from harness import judge
    out = {"cell": cell.name, "program": {}, "control": {}}
    for seed in program_seeds:
        t = time.perf_counter()
        out["program"][str(seed)] = program_readings(cell, seed, device)
        log(f"[program] seed {seed}: {out['program'][str(seed)]} "
            f"({time.perf_counter() - t:.1f} s)")
    for seed in control_seeds:
        t = time.perf_counter()
        ans = control_answer(cell, seed, device)
        out["control"][str(seed)] = judge.numbers(
            cell.traffic["request"], cell.config, cell.traffic, [ans],
            device)
        log(f"[control] seed {seed}: {out['control'][str(seed)]} "
            f"({time.perf_counter() - t:.1f} s)")
    for name in next(iter(out["program"].values()), {}):
        lo = max(r[name] for r in out["program"].values())
        up = min((r[name] for r in out["control"].values()), default=None)
        log(f"[readings] {name}: lower {lo!r}, upper {up!r}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    from harness.spec import Cell
    if not torch.cuda.is_available():
        print("control.py: needs a CUDA device", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    seeds = [args.first_seed + 7919 * k for k in range(args.program_seeds)]
    ctrl = [args.first_seed + 104729 * (k + 1)
            for k in range(args.control_seeds)]
    out = readings(cell, seeds, ctrl, torch.device("cuda", 0),
                   log=lambda m: print(m, flush=True))
    out["card"] = torch.cuda.get_device_name(0)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
