"""The yardstick of the ion-ion pair kernel: the float64 work a
ground-state request needs from the damped real-space pair sum, and the
least time the card could take for it.

A request sums the pairs twice: the energy in ``place_ions`` and the
energy with its gradients in ``forces``.  Each sum needs the ordered
pairs (i, j, image) within the cutoff, N^2 (4 pi Rc^3 / 3) / V of them for
N ions at the cell's mean density; the candidates outside it are the
kernel's own cost and are not counted.  A pair is weighed by the FP64
flops of its term (an FMA counts two, as the peak does), with each
special function counted at the FMAs of a short evaluation of it, fewer
than the card's math library spends:

- distance d = R_j - (R_i - t_b) and r^2: 3 subtractions, 1 product and
  2 FMAs: 8;
- r = sqrt(r^2) and 1 / r: a reciprocal-square-root seed refined by
  4 FMAs each: 16;
- x = r / rd: 1;
- erfc(x) = exp(-x^2) R(x): exp as a range reduction and a degree-10
  polynomial (12 FMAs: 24), R a rational fit (two degree-5 polynomials
  and a division, 12 FMAs: 24): 48;
- the term Z_i Z_j erfc / r (3 products) and the sums of the energy and
  of the neighbour charge (2 additions): 5;

78 for the energy.  The gradient adds exp(-x^2) (x^2 and exp: 25),
f = -(Z_i Z_j c exp + e) / r^2 (5) and the sums of f d into the ion's
and the image's gradient (6 FMAs: 12): 42, so 120 for a pair of the
forces' sum.  The bound is the flops at ``PEAKS["fp64_flops"]``; FP64
arithmetic, not memory, bounds the kernel (its inputs are kilobytes).
"""

import math

import numpy as np

from .roofline import PEAKS
from .spec import A_PER_BOHR, ROOT, ideal_cell, ion_ion_rc_bohr, load_json

ION_PAIR_KERNELS = ("ion_pair",)
ENERGY_FLOPS_PER_PAIR = 8 + 16 + 1 + 48 + 5
FORCE_FLOPS_PER_PAIR = ENERGY_FLOPS_PER_PAIR + 25 + 5 + 12


def pairs_within(n_ions, rc_bohr, volume_bohr3):
    """Ordered pairs (i, j, image) within the cutoff at the mean density."""
    return n_ions * n_ions * (4.0 * math.pi * rc_bohr ** 3 / 3.0) \
        / volume_bohr3


def request_flops(n_ions, rc_bohr, volume_bohr3):
    """One energy sum and one forces sum over the pairs within Rc."""
    return pairs_within(n_ions, rc_bohr, volume_bohr3) \
        * (ENERGY_FLOPS_PER_PAIR + FORCE_FLOPS_PER_PAIR)


def request_bound_s(n_ions, rc_bohr, volume_bohr3):
    return request_flops(n_ions, rc_bohr, volume_bohr3) / PEAKS["fp64_flops"]


def cell_geometry(ctx):
    """(ions, Rc [bohr], volume [bohr^3]) of the configuration a run
    serves: the ones in ``BENCHMARK.json`` whose grid is the run's and
    whose ideal supercell holds as many ions as the answers; None where
    none does.  Raises where two such configurations differ in Rc or
    volume, since the run's own is not known here."""
    n = next((len(a["cart_A"]) for a in ctx.answers if "cart_A" in a),
             None)
    if n is None:
        return None
    found = {}
    for entry in load_json(ROOT / "BENCHMARK.json")["configs"]:
        conf = load_json(ROOT / entry["file"])
        if tuple(conf["grid"]) != tuple(ctx.shape) \
                or "ion_ion_rc_heights" not in conf:
            continue
        box, frac = ideal_cell(conf)
        if frac.shape[0] == n:
            found[entry["name"]] = (
                n, ion_ion_rc_bohr(conf),
                abs(np.linalg.det(box)) / A_PER_BOHR ** 3)
    if len(set(found.values())) > 1:
        raise ValueError(f"configurations {sorted(found)} share the grid "
                         f"{tuple(ctx.shape)} and {n} ions but differ in "
                         "Rc or volume: the pair roofline cannot tell "
                         "which the run serves")
    return next(iter(found.values()), None)
