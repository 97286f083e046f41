"""The 2048-ion fcc Al configuration (``al-fcc-2048-wt-pbe-f64``) and its
cell ``al2048-f64.gs-cold`` on the CPU at a small size: the configuration
holds its shapes; the harness drives the cell cut to 2x2x2 conventional
cells (32 ions) at that cell's own 2000 eV grid, which has the full cell's
spacing, with PME of order 20, and the judge finds it correct, while the
float32 control and planted faults fail it; the port's PME energies and
forces sit on the reference's exact-structure-factor ones at a fixed
density; and the pair kernel's yardstick and readers."""

import importlib.util
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _paths import BENCH
import run as bench_run
from harness import pair_roofline
from harness.program import Server, build_system
from harness.spans import Spans
from harness.spec import (A_PER_BOHR, Cell, ideal_cell, ion_ion_rc_bohr,
                          recpot_path)
from harness.traffic import Requests
from reference import ofdft as R

CPU = torch.device("cpu")
NAME = "al2048-f64.gs-cold"
CONF = json.loads((BENCH / "configs" / "al-fcc-2048-wt-pbe-f64.json")
                  .read_text())
# 2x2x2 conventional cells: ecut2shape(2000 eV) gives 61^3, a spacing of
# 0.1332 A against the full cell's 0.1360 A
SMALL = {"supercell": [2, 2, 2], "grid": [61, 61, 61]}


def test_configuration_holds_its_shapes():
    from professad_tpu_torch import System
    box, frac = ideal_cell(CONF)
    assert frac.shape == (2048, 3)
    assert abs(abs(np.linalg.det(box)) / 2048 - 16.764) < 1e-3
    assert System.ecut2shape(CONF["ecut_eV"], box) == (239, 239, 239) \
        == tuple(CONF["grid"])
    assert CONF["pme_order"] == 20 and CONF["dtype"] == "float64"
    small = dict(CONF, **SMALL)
    assert System.ecut2shape(CONF["ecut_eV"], ideal_cell(small)[0]) \
        == tuple(SMALL["grid"])


def test_harness_drives_the_cell_and_judges_it_correct():
    cell = Cell(NAME)
    cell.config.update(SMALL)
    res = bench_run.run_cell(cell, 2 ** 32 + 17, 0.5, 0, CPU,
                             log=lambda m: None)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}


def _altered_forces(monkeypatch):
    from professad_tpu_torch import System
    orig = System.forces

    def forces(self, units="Ha/b"):
        F = orig(self, units).clone()
        F[0, 0] += 0.01 if units == "eV/a" else 0.01 / 51.42
        return F
    monkeypatch.setattr(System, "forces", forces)


def _unchanged_solve(monkeypatch):
    from professad_tpu_torch.ops import solvers
    orig = solvers.tpgd_minimize

    def stuck(vg, x0, *a, **k):
        st, it, conv = orig(vg, x0, *a, **k)
        return st._replace(x=x0), it, conv
    monkeypatch.setattr(solvers, "tpgd_minimize", stuck)


@pytest.mark.parametrize("fault", [None, _altered_forces, _unchanged_solve],
                         ids=["control", "altered_forces", "unchanged_solve"])
def test_faults_and_control_are_not_correct(fault, monkeypatch):
    """At the cut size, the float32 control (the reference in the
    program's place) and two planted faults of the program fail the
    cell's limits."""
    from harness import judge
    import control
    cell = Cell(NAME)
    cell.config.update(SMALL)
    seed = 2 ** 32 + 29
    if fault is None:
        ans = control.control_answer(cell, seed, CPU)
        nums = judge.numbers("ground_state", cell.config, cell.traffic,
                             [ans], CPU)
        correct, checks = judge.verdict(nums, cell.limits)
    else:
        fault(monkeypatch)
        res = bench_run.run_cell(cell, seed, 0.5, 0, CPU,
                                 log=lambda m: None)
        correct, checks = res["correct"], res["checks"]
    assert correct is False, checks


def test_pme_program_against_the_exact_reference():
    """At the program's ground-state density of a displaced 32-ion cell:
    its energy (PME order 20 for v_ext) against the reference's density
    terms with the exact structure factor plus the reference's ion-ion sum,
    and its forces against the reference's.  PME 20's own error at this
    spacing is ~1e-11 meV/atom and ~1e-10 meV/A (PME against the port's
    exact path, CPU); the rest is rounding: totals of ~1.8e3 eV that the
    two sum in other orders over the grid differ by ~1e-12 of themselves,
    6e-8 meV/atom.  1e-6 meV/atom and 1e-8 meV/A leave room for that
    alone: the float32 control is 3e-3 meV/atom and 0.02 meV/A away."""
    conf = dict(CONF, **SMALL)
    mix = Cell(NAME).traffic
    req = Requests(mix, conf, 2 ** 33 + 5).next()
    server = Server(build_system(conf, CPU), conf, mix, Spans(lambda: None))
    ans = server.ground_state(req["cart_A"], from_uniform=True, keep=True)
    assert ans["converged"]
    box_A, _ = ideal_cell(conf)
    box = torch.tensor(box_A / A_PER_BOHR, dtype=torch.float64)
    cart = torch.tensor(req["cart_A"] / A_PER_BOHR, dtype=torch.float64)
    frac = cart @ torch.linalg.inv(box)
    shape = tuple(conf["grid"])
    table = R.read_recpot(recpot_path(conf))
    vext = R.v_ext(box, shape, R.structure_factor(frac, shape), table)
    n = ans["density"].to(torch.float64)
    charges = torch.full((32,), float(table[2]), dtype=torch.float64)
    E_ii, F_ii = R.ion_ion(box, cart, charges, ion_ion_rc_bohr(conf),
                           forces=True)
    E = (float(R.density_terms(conf["terms"], box, n, vext)) + float(E_ii)) \
        * R.EV_PER_HA
    F = (R.electron_ion_forces(box, n, frac, table) + F_ii).numpy() \
        * R.EV_PER_HA / A_PER_BOHR
    dE, dF = 1e3 * abs(ans["E_eV"] - E) / 32, \
        1e3 * np.max(np.abs(ans["F_eV_A"] - F))
    assert dE < 1e-6 and dF < 1e-8, (dE, dF)


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        name, BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class _Trace:
    """A trace whose kernels named with ``ion_pair`` ran ``s`` seconds."""

    def __init__(self, s):
        self.s = s

    def kernel_s(self, markers):
        assert tuple(markers) == pair_roofline.ION_PAIR_KERNELS
        return self.s


def test_pair_yardstick_and_readers():
    """The work of a request at 2048 ions, Rc six heights: 3.79e9 pairs
    within the cutoff, 198 flops each over the two sums, 22.1 ms at the
    FP64 peak; the readers scale it by the profiled requests, find the
    configuration from the run's grid and ions, and return None where the
    trace holds no pair kernel (a program without it)."""
    box, frac = ideal_cell(CONF)
    geo = (2048, ion_ion_rc_bohr(CONF),
           abs(np.linalg.det(box)) / A_PER_BOHR ** 3)
    assert pair_roofline.pairs_within(*geo) == pytest.approx(3.795e9,
                                                             rel=1e-3)
    assert pair_roofline.ENERGY_FLOPS_PER_PAIR \
        + pair_roofline.FORCE_FLOPS_PER_PAIR == 198
    bound = pair_roofline.request_bound_s(*geo)
    assert bound == pytest.approx(22.10e-3, rel=1e-3)
    ctx = SimpleNamespace(trace=_Trace(0.2), n_profiled=2,
                          answers=[{"cart_A": frac @ box}],
                          shape=tuple(CONF["grid"]))
    assert pair_roofline.cell_geometry(ctx) == pytest.approx(geo)
    assert _reader("ion_pair_device_ms")(ctx) == pytest.approx(100.0)
    assert _reader("ion_pair_roofline")(ctx) == \
        pytest.approx(100 * 2 * bound / 0.2)
    for none in (dict(trace=_Trace(0.0)), dict(trace=None),
                 dict(shape=(95, 95, 117))):
        c = SimpleNamespace(**dict(vars(ctx), **none))
        assert _reader("ion_pair_roofline")(c) is None
    assert _reader("ion_pair_device_ms")(
        SimpleNamespace(**dict(vars(ctx), trace=_Trace(0.0)))) is None


def test_pair_geometry_refuses_an_ambiguous_configuration(monkeypatch):
    """Two configurations of the run's grid and ion count that differ in
    Rc: the yardstick cannot tell which the run serves, and says so
    rather than taking the first; the same configuration twice is no
    ambiguity."""
    box, frac = ideal_cell(CONF)
    ctx = SimpleNamespace(answers=[{"cart_A": frac @ box}],
                          shape=tuple(CONF["grid"]))
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == CONF["name"])
    other = dict(CONF, ion_ion_rc_heights=8)
    files = {"twin.json": other}
    real = pair_roofline.load_json

    def load(path):
        return files.get(path.name) or real(path)
    monkeypatch.setattr(pair_roofline, "load_json", load)
    files["BENCHMARK.json"] = dict(bench, configs=[
        entry, dict(entry, name="twin", file="twin.json")])
    with pytest.raises(ValueError, match="differ in Rc or volume"):
        pair_roofline.cell_geometry(ctx)
    files["twin.json"] = CONF
    assert pair_roofline.cell_geometry(ctx)[0] == 2048
