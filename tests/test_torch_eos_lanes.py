"""The port's batched EOS scan with L-BFGS against the JAX package's, and
each lane of the vmapped solve against the port's serial solve of that
lane alone (see test_torch_eos_batched.py)."""

import numpy as np
import pytest

from eos_cases import torch_system
from test_torch_eos_batched import check_batched_matches_jax


def test_batched_lbfgs_matches_jax(monkeypatch):
    check_batched_matches_jax(monkeypatch, "LBFGS")


@pytest.mark.parametrize("n_method,analytic", [("TPGD", True),
                                               ("LBFGS", False)])
def test_batched_lanes_match_serial_solve(n_method, analytic):
    """Each lane of the vmapped solve against the serial solvers on that
    lane alone: same iterations and convergence; energies measured within
    2.2e-16 Ha, bound 1e-10 Ha."""
    s = torch_system()
    vs = s.volume("a3") * np.linspace(0.96, 1.04, 4)
    norm = (s.lattice_vectors("a") / s.volume("a3") ** (1 / 3)).numpy()
    box, vext, chi, _ = s._eos_points(vs, norm)
    kw = dict(n_method=n_method, lr=1.0, ntol=1e-9, conv_count=3,
              max_iter=200, analytic=analytic)
    f, conv, its = s._eos_solve_fn(**kw)(chi, box, vext)
    serial = s._eos_solve_fn(batched=False, **kw)
    for b in range(len(vs)):
        f1, conv1, it1 = serial(chi[b], box[b], vext[b])
        assert conv[b] and conv1 and its[b] == it1
        assert abs(float(f[b]) - float(f1)) < 1e-10
