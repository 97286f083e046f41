"""``BENCHMARK.json`` and the files it names: every cell finds its
configuration, mix, limits and metric readers by name; the configurations
hold the shapes they state; a run's last line has the driver's shape; a
run loads no module whose whole top-level name is JAX's or the JAX
package's, and without a card it prints nothing."""

import json
import re
import subprocess
import sys

import numpy as np
import pytest

from _paths import BENCH, ROOT
import run as bench_run
from harness.spec import Cell, ideal_cell

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_keys_names_and_files():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in SPEC["configs"]] + \
        [w["name"] for w in SPEC["workloads"]] + \
        [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names)) and all(map(NAME.match, names))
    for c in SPEC["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) == set(data["reduced"])
        assert data["source"] == c["source"] and len(c["source"]) <= 200
    for w in SPEC["workloads"]:
        cell = Cell(w["name"])
        assert set(cell.limits) and cell.chips == 1
        assert len(w["why"]) <= 200
    for m in SPEC["per_layer"]:
        assert bench_run.load_reader(m["name"]) is not None
        ends = {e["name"] for e in SPEC["end_to_end"]}
        assert m["moves"] in ends
        # every cell the metric lists reports the metric it moves
        for w in m.get("workloads", [x["name"] for x in SPEC["workloads"]]):
            assert m["moves"] in {e["name"] for e in Cell(w).end_to_end}
    for w in SPEC["workloads"]:
        cell = Cell(w["name"])
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


def test_configurations_hold_their_shapes():
    from professad_tpu_torch import System
    confs = {n: json.loads((BENCH / "configs" / f"{n}.json").read_text())
             for n in ("mg-hcp-96-wtexp-pbe", "mg-hcp-96-wtexp-pbe-f64")}
    for mg in confs.values():
        box, frac = ideal_cell(mg)
        assert frac.shape == (96, 3)
        assert abs(abs(np.linalg.det(box)) / 96 - 23.151) < 1e-9
        assert System.ecut2shape(mg["ecut_eV"], box) == (95, 95, 117) \
            == tuple(mg["grid"])
    f32, f64 = confs.values()
    assert (f32["dtype"], f64["dtype"]) == ("float32", "float64")
    # the two differ in their precision alone
    assert {k for k in f32 if f32[k] != f64[k]} == {"name", "dtype",
                                                    "assumed"}


def test_forbidden_modules_compare_whole_names():
    f = bench_run.forbidden_modules
    assert f({"professad_tpu_torch": 0, "professad_tpu_torch.ops": 0}) == []
    assert f({"professad_tpu.system": 0, "jaxlib.xla": 0}) == \
        ["jaxlib", "professad_tpu"]
    assert f({"jax": 0, "jax_cosmo": 0, "flax.linen": 0}) == ["flax", "jax"]


def test_without_a_card_it_exits_and_prints_nothing():
    res = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "mg96-f64.gs-cold", "--seed", "5", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(ROOT)})
    assert res.returncode != 0 and res.stdout == ""


SMALL = {"supercell": [1, 1, 1], "grid": [15, 15, 24]}
DRIVE = """
import json, sys, torch
sys.path[:0] = [{root!r}, {bench!r}]
import run
from harness.spec import Cell
cell = Cell({cell!r}); cell.config.update({small!r})
res = run.run_cell(cell, 2 ** 32 + 3, 0.5, {trace}, torch.device("cpu"))
print(json.dumps(res)); print(json.dumps(run.forbidden_modules()))
"""


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_shape_and_no_jax(trace):
    code = DRIVE.format(root=str(ROOT), bench=str(BENCH),
                        cell="mg96-f64.gs-cold", small=SMALL, trace=trace)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    line, bad = res.stdout.strip().splitlines()[-2:]
    assert json.loads(bad) == []
    out = json.loads(line)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(out)[-1] == "checks"
    assert out["correct"] is True and out["attempted"] >= 1
    cell = Cell("mg96-f64.gs-cold")
    want = cell.per_layer if trace else cell.end_to_end
    got = set(out["metrics"])
    assert got <= {m["name"] for m in want}
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert got == {m["name"] for m in want}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and np.isfinite(m["value"])
    for v, lim in out["checks"].values():
        assert v <= lim
