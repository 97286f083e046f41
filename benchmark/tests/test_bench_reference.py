"""The plain reference on its own: the PROFESS-4 golden energies, its
forces against its own central differences, and its independence of the
program (it loads nothing of ``professad_tpu_torch``, the JAX package or
JAX)."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from _paths import BENCH
from reference import ofdft as R

POT = BENCH / "reference" / "potentials"
F64 = torch.float64


def _energy_eV(cell_A, fracs, pot, kinetic, shape=(18, 18, 18)):
    box = torch.tensor(np.asarray(cell_A) / R.A_PER_BOHR, dtype=F64)
    frac = torch.tensor(fracs, dtype=F64)
    table = R.read_recpot(POT / pot)
    vext = R.v_ext(box, shape, R.structure_factor(frac, shape), table)
    terms = ["IonIon", "IonElectron", "Hartree", kinetic, "PBE"]
    _, E, _, conv = R.ground_state(terms, box, vext,
                                   float(table[2] * len(fracs)), ntol=1e-12)
    charges = torch.full((len(fracs),), float(table[2]), dtype=F64)
    rc = 12.0 * R.cell_heights(box.numpy()).max()    # the default rule
    assert conv
    return (float(E) + float(R.ion_ion(box, frac @ box, charges, rc))) \
        * R.EV_PER_HA


@pytest.mark.parametrize("case", [
    (4.05 * np.array([[.5, .5, 0], [0, .5, .5], [.5, 0, .5]]), [[0, 0, 0]],
     "al.gga.recpot", "WangTeter", -57.183329401794985),
    (3.48 * np.eye(3), [[0, 0, 0], [.5, .5, .5]], "li.gga.recpot",
     "SmargiassiMadden", -14.741886997024537),
], ids=["fcc-Al-WT", "bcc-Li-SM"])
def test_golden_energies(case):
    cell, fracs, pot, kinetic, golden = case
    assert abs(_energy_eV(cell, fracs, pot, kinetic) - golden) < 1e-4


@pytest.mark.parametrize("kinetic", ["WangTeter", "WangTeterExp"])
def test_forces_match_central_differences(kinetic):
    """-dE/dR at a fixed density (both ion terms) against central
    differences of the energy, on a displaced 4-ion fcc Al cell."""
    shape = (16, 16, 16)
    box = torch.tensor(4.05 / R.A_PER_BOHR * np.eye(3), dtype=F64)
    frac = torch.tensor([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]],
                        dtype=F64) + 0.01 * torch.tensor(
        np.random.default_rng(0).standard_normal((4, 3)))
    table = R.read_recpot(POT / "al.gga.recpot")
    terms = ["IonIon", "IonElectron", "Hartree", kinetic, "PBE"]
    vext = R.v_ext(box, shape, R.structure_factor(frac, shape), table)
    den, _, _, _ = R.ground_state(terms, box, vext, 12.0, ntol=1e-12)
    charges = torch.full((4,), 3.0, dtype=F64)
    rc = 6.0 * R.cell_heights(box.numpy()).max()

    def energy(cart):
        f = cart @ torch.linalg.inv(box)
        v = R.v_ext(box, shape, R.structure_factor(f, shape), table)
        return float(R.ion_electron(box, den, v)
                     + R.ion_ion(box, cart, charges, rc))

    cart = frac @ box
    F = R.electron_ion_forces(box, den, frac, table) + \
        R.ion_ion(box, cart, charges, rc, forces=True)[1]
    h = 1e-4
    for i, c in [(0, 0), (1, 2), (3, 1)]:
        d = torch.zeros_like(cart)
        d[i, c] = h
        fd = -(energy(cart + d) - energy(cart - d)) / (2 * h)
        assert abs(float(F[i, c]) - fd) < 1e-7


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "from reference import ofdft; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'professad_tpu_torch', 'professad_tpu', 'jax', 'jaxlib'}); "
            "print(bad); sys.exit(1 if bad else 0)") % str(BENCH)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
