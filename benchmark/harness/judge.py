"""The comparison that decides ``correct``: the plain reference
(``reference/ofdft.py``) works out again, from the inputs the benchmark
made, what each judged answer of the program should be, and each number
compared is held to its limit (``limits/<cell>.json``).

A ground-state answer (energy, forces, converged density) gives:

- ``E_gap_meV_atom``: |E_program - E_reference| per ion, E_reference the
  energy of the reference's own float64 ground state of the same ions,
  every term of the configuration, the ion-ion sum and the ion set-up
  (exact structure factor, v_ext) included;
- ``euler_meV``: the density-weighted RMS of dE/dn - mu at the program's
  density, which is zero at the ground state: how far the density a user
  gets lies from the ground state;
- ``F_gap_at_density_meV_A``: the largest |F_program - F_reference| over
  ions and components, F_reference the reference's Hellmann-Feynman and
  ion-ion forces at the program's density: the forces layer.  A density
  off the ground state moves the forces a user gets by about its Euler
  residual (in meV/A per meV), and that residual is held on its own.

An EOS answer (each volume's energy and the fitted V0, K0) gives:

- ``E_gap_meV_atom``: the largest |E_program(V) - E_reference(V)| per ion
  over the volumes, E_reference the reference's own float64 ground state;
- ``V0_rel``, ``K0_rel``: the relative gaps of the program's fitted V0 and
  K0 to the reference's fit of its own energies.

Each number is the largest over the judged answers of a run.
"""

import numpy as np
import torch

from reference import ofdft as R

from .spec import A_PER_BOHR, ideal_cell, ion_ion_rc_bohr, recpot_path


def _setup(config, device):
    box_A, frac0 = ideal_cell(config)
    table = R.read_recpot(recpot_path(config))
    charges = torch.full((frac0.shape[0],), float(table[2]),
                         dtype=torch.float64, device=device)
    return box_A, frac0, table, charges


def ground_state_numbers(config, answer, device):
    """The three numbers of one ground-state answer; ``answer`` carries the
    request's ions (``cart_A``) beside the program's (or a control's)
    ``E_eV``, ``F_eV_A`` and ``density``.  The reference solves for its
    own float64 ground state of those ions for the energy."""
    _, _, table, charges = _setup(config, device)
    terms = config["terms"]
    shape = tuple(config["grid"])
    box_A, _ = ideal_cell(config)
    box = torch.tensor(box_A / A_PER_BOHR, dtype=torch.float64, device=device)
    cart = torch.tensor(np.asarray(answer["cart_A"]) / A_PER_BOHR,
                        dtype=torch.float64, device=device)
    frac = cart @ torch.linalg.inv(box)
    n_ions = cart.shape[0]
    vext = R.v_ext(box, shape, R.structure_factor(frac, shape), table)
    _, E, _, _ = R.ground_state(terms, box, vext, float(table[2] * n_ions),
                                ntol=1e-12 * n_ions)
    n = answer["density"].to(device=device, dtype=torch.float64)
    F = R.electron_ion_forces(box, n, frac, table)
    if "IonIon" in terms:
        E_ii, F_ii = R.ion_ion(box, frac @ box, charges,
                               ion_ion_rc_bohr(config), forces=True)
        E, F = E + E_ii, F + F_ii
    E_eV = float(E) * R.EV_PER_HA
    F_eV_A = F.cpu().numpy() * R.EV_PER_HA / A_PER_BOHR
    euler = float(R.euler_rms(terms, box, n, vext)) * R.EV_PER_HA
    return {
        "E_gap_meV_atom": 1e3 * abs(answer["E_eV"] - E_eV) / n_ions,
        "euler_meV": 1e3 * euler,
        "F_gap_at_density_meV_A": 1e3 * float(np.max(np.abs(
            np.asarray(answer["F_eV_A"]) - F_eV_A))),
    }


def eos_points(config, mix, c_over_a, device):
    """The scan's cells (N, 3, 3) [bohr] and volumes [A^3 / atom], as
    ``System.eos_fit`` spaces them: N volumes within +-f of the cell's."""
    box_A, frac = ideal_cell(config, c_over_a=c_over_a)
    v0 = abs(np.linalg.det(box_A))
    vs = v0 * np.linspace(1 - mix["f"], 1 + mix["f"], mix["N"])
    boxes = np.stack([(v / v0) ** (1.0 / 3.0) * box_A for v in vs])
    return (torch.tensor(boxes / A_PER_BOHR, dtype=torch.float64,
                         device=device), vs / frac.shape[0], frac)


def eos_reference(config, mix, c_over_a, device, dtype=torch.float64,
                  quant=R.identity, max_iter=2000):
    """Each volume's ground-state energy [eV/atom] by the reference's own
    solve (every volume a lane), and its Birch-Murnaghan fit; in
    ``dtype`` with fields through ``quant`` for the control."""
    boxes, vols, frac0 = eos_points(config, mix, c_over_a, device)
    _, _, table, charges = _setup(config, device)
    shape = tuple(config["grid"])
    frac = torch.tensor(frac0, dtype=torch.float64, device=device)
    vext = R.v_ext(boxes, shape, R.structure_factor(frac, shape), table)
    n_ions = frac.shape[0]
    ntol = 1e-12 * n_ions if dtype == torch.float64 \
        else config["ntol_eV_per_atom"] * n_ions / R.EV_PER_HA
    _, E, _, conv = R.ground_state(config["terms"], boxes, vext,
                                   float(table[2] * n_ions), dtype=dtype,
                                   quant=quant, ntol=ntol, max_iter=max_iter)
    E = E.to(torch.float64)
    if "IonIon" in config["terms"]:
        rc = ion_ion_rc_bohr(config)
        E = E + torch.stack([R.ion_ion(b, frac @ b, charges, rc)
                             for b in boxes])
    e = (E * R.EV_PER_HA / n_ions).cpu().numpy()
    K0, _, _, V0 = R.birch_murnaghan(vols, e)
    return {"table": [[float(v), float(x)] for v, x in zip(vols, e)],
            "params": [K0, None, None, V0], "converged": conv}


def eos_numbers(config, mix, answer, device):
    ref = eos_reference(config, mix, answer["c_over_a"], device)
    prog = np.asarray(answer["table"], dtype=np.float64)
    want = np.asarray(ref["table"])
    if prog.shape != want.shape or np.max(np.abs(prog[:, 0] - want[:, 0])) \
            > 1e-6:
        return {"E_gap_meV_atom": float("inf"), "V0_rel": float("inf"),
                "K0_rel": float("inf")}
    K0, V0 = answer["params"][0], answer["params"][3]
    return {
        "E_gap_meV_atom": 1e3 * float(np.max(np.abs(prog[:, 1]
                                                    - want[:, 1]))),
        "V0_rel": abs(V0 - ref["params"][3]) / ref["params"][3],
        "K0_rel": abs(K0 - ref["params"][0]) / ref["params"][0],
    }


def numbers(kind, config, mix, answers, device):
    """The largest of each number over the judged answers."""
    out = {}
    for a in answers:
        got = ground_state_numbers(config, a, device) \
            if kind == "ground_state" else eos_numbers(config, mix, a, device)
        for k, v in got.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def verdict(nums, limits):
    """(correct, {name: [number, limit]}): every number within its limit;
    a number that is missing or not finite fails."""
    checks = {k: [nums.get(k), lim["limit"]] for k, lim in limits.items()}
    ok = all(v is not None and np.isfinite(v) and v <= lim
             for v, lim in checks.values())
    return bool(ok), checks
