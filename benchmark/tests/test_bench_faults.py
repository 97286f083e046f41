"""``correct`` comes out false when the timed path is broken underneath:
the harness drives the rest of a run (on the CPU, at a small size, past
its look for a card) with one fault planted in the program, and the
control (the reference put in the program's place in the precision below
the configuration's: float32 for float64, bfloat16 storage for float32)
fails the cell's limits.  A sound run at the same size comes out correct.

The faults a cell can have: a solve that returns its state unchanged
(every cell); half of the EOS scan's lanes left out, their volumes
answered from the other half (the EOS cell); an answer altered where it is
produced (the forces, or one volume's energy).  No cell runs on more than
one chip, so there is no exchange between chips to leave out."""

import pytest
import torch

import _paths  # noqa: F401
import control
import run as bench_run
from harness.spec import Cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77
SMALL = {
    "mg96-f64.gs-cold": {"supercell": [1, 1, 1], "grid": [15, 15, 24]},
    "mg96-f64.md-warm": {"supercell": [1, 1, 1], "grid": [15, 15, 24]},
    "mg96.eos-scan": {"supercell": [1, 1, 1], "grid": [15, 15, 24]},
}


def _cell(name):
    cell = Cell(name)
    cell.config.update(SMALL[name])
    return cell


def _run(name):
    return bench_run.run_cell(_cell(name), SEED, 0.5, 0, CPU,
                              log=lambda m: None)


def _unchanged(monkeypatch):
    from professad_tpu_torch.ops import solvers
    for fn in ("tpgd_minimize", "tpgd_minimize_lanes"):
        orig = getattr(solvers, fn)

        def stuck(vg, x0, *a, _orig=orig, **k):
            st, it, conv = _orig(vg, x0, *a, **k)
            return st._replace(x=x0), it, conv
        monkeypatch.setattr(solvers, fn, stuck)


def _half_lanes(monkeypatch):
    from professad_tpu_torch.ops import solvers
    orig = solvers.tpgd_minimize_lanes

    def half(vg, x0, lanes=(), **k):
        B, h = x0.shape[0], (x0.shape[0] + 1) // 2
        st, it, conv = orig(vg, x0[:h], lanes=tuple(l[:h] for l in lanes),
                            **k)
        fill = list(range(h)) + list(range(B - h))
        return (st._replace(x=st.x[fill], f=st.f[fill]),
                [it[i] for i in fill], [conv[i] for i in fill])
    monkeypatch.setattr(solvers, "tpgd_minimize_lanes", half)


def _altered(monkeypatch):
    from professad_tpu_torch import System
    f_orig, e_orig = System.forces, System._eos_energy

    def forces(self, units="Ha/b"):
        F = f_orig(self, units).clone()
        F[0, 0] += 0.01 if units == "eV/a" else 0.01 / 51.42
        return F

    def eos_energy(self, chi, box, v_ext):
        return e_orig(self, chi, box, v_ext) + 1e-4
    monkeypatch.setattr(System, "forces", forces)
    monkeypatch.setattr(System, "_eos_energy", eos_energy)


CELLS = list(SMALL)
FAULTS = [("unchanged", _unchanged, CELLS),
          ("half_lanes", _half_lanes, ["mg96.eos-scan"]),
          ("altered", _altered, CELLS)]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("fault,name", [(f, c) for f, _, cells in FAULTS
                                        for c in cells])
def test_planted_fault_is_not_correct(fault, name, monkeypatch):
    dict((f, p) for f, p, _ in FAULTS)[fault](monkeypatch)
    res = _run(name)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    from harness import judge
    cell = _cell(name)
    ans = control.control_answer(cell, SEED, CPU)
    nums = judge.numbers(cell.traffic["request"], cell.config, cell.traffic,
                         [ans], CPU)
    correct, checks = judge.verdict(nums, cell.limits)
    assert correct is False, checks
