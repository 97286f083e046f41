"""What a cell is made of, found by name: its entry in ``BENCHMARK.json``,
its configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``) and its limits (``limits/<cell>.json``), and
the geometry every configuration describes."""

import json
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
A_PER_BOHR = 0.529177210903


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


class Cell:
    """One workload of ``BENCHMARK.json`` with its files."""

    def __init__(self, name):
        bench = load_json(ROOT / "BENCHMARK.json")
        entry = next((w for w in bench["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise ValueError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        conf = next(c for c in bench["configs"]
                    if c["name"] == entry["config"])
        self.config = load_json(ROOT / conf["file"])
        self.traffic = load_json(BENCH_DIR / "traffic"
                                 / f"{entry['traffic']}.json")
        self.limits = load_json(BENCH_DIR / "limits" / f"{name}.json")
        self.chips = int(entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]


def recpot_path(config):
    return str(BENCH_DIR / config["recpot"])


def ideal_cell(config, c_over_a=None):
    """(box [A] (3, 3), fractional coordinates (N, 3)) of the configuration's
    perfect supercell; ``c_over_a`` overrides an hcp cell's ratio at the
    configuration's volume per atom."""
    reps = np.asarray(config["supercell"])
    lat = config["lattice"]
    if lat == "fcc":
        prim = config["a_A"] * np.eye(3)
        basis = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    elif lat == "hcp":
        ca = config["c_over_a"] if c_over_a is None else c_over_a
        vol2 = 2.0 * config["volume_A3_per_atom"]
        a = (vol2 / (np.sqrt(3.0) / 2.0 * ca)) ** (1.0 / 3.0)
        prim = a * np.array([[1.0, 0, 0], [-0.5, np.sqrt(3.0) / 2, 0],
                             [0, 0, ca]])
        basis = np.array([[1 / 3, 2 / 3, 0.75], [2 / 3, 1 / 3, 0.25]])
    else:
        raise ValueError(f"unknown lattice {lat!r}")
    cells = np.stack(np.meshgrid(*(np.arange(r) for r in reps),
                                 indexing="ij"), -1).reshape(-1, 3)
    frac = ((cells[:, None, :] + basis[None]) / reps).reshape(-1, 3)
    return prim * reps[:, None], frac


def ion_ion_rc_bohr(config):
    """The ion-ion cutoff [bohr]: ``ion_ion_rc_heights`` times the largest
    height of the ideal supercell."""
    box, _ = ideal_cell(config)
    inv_t = np.linalg.inv(box.T / A_PER_BOHR)
    h = 1.0 / np.sqrt(np.sum(inv_t ** 2, axis=1))
    return float(config["ion_ion_rc_heights"] * np.max(h))


def ntol_eV(config, n_ions):
    """The |dE| stopping rule [eV] of the whole cell."""
    return float(config["ntol_eV_per_atom"] * n_ions)
