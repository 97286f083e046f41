"""The port's geometry example (examples/torch_geometry_optimization.py)
on the CPU: both relaxations for a few steps at coarse grids.  A JAX
relaxation costs minutes here, so the steps are held to the JAX package by
``test_torch_geometry_cell.py`` (ions + cell) and
``test_torch_geometry_param.py`` (a parameterized relaxation), 3 steps each
at rtol 1e-8; this file checks that the example drives them.
"""

import os
import sys

import numpy as np

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
sys.path.insert(0, EXAMPLES)

import torch_geometry_optimization as geo  # noqa: E402


def test_geometry_example_steps():
    out = geo.main(device="cpu", n=10, hcp_shape=(8, 8, 12), g_maxiter=3)
    cell = out["cell"]
    assert cell["lattice"].shape == (3, 3) and cell["frac"].shape == (2, 3)
    assert np.all(np.isfinite(cell["lattice"]))
    assert np.isfinite(cell["max_force"]) and np.isfinite(cell["max_stress"])
    # the sheared cell relaxes toward the cubic one: less shear than the
    # start's 0.02-0.03 a
    off = cell["lattice"] - np.diag(np.diag(cell["lattice"]))
    assert np.max(np.abs(off)) < 0.03 * 3.48
    hcp = out["hcp"]
    assert hcp["a"] < 6.0 and 1.5 < hcp["c_over_a"] < 1.8
