"""The port's batched EOS scan (``eos_fit(batched=True)``: every volume a
lane of one ``torch.func.vmap``-ped solve) against the JAX package's
(``jax.vmap`` of its whole-optimization program) at 10^3, f64, with TPGD.
The L-BFGS case is in test_torch_eos_lanes.py: each file pays one JAX
set-up and one compile of the vmapped program."""

import numpy as np

import professad_tpu.system as jsys
import professad_tpu_torch.system as tsys
from eos_cases import jax_system, torch_system, eos_points


def check_batched_matches_jax(monkeypatch, n_method):
    """ntol 1e-9, lr 1.0 (the batched default): measured per-point
    energies within 9.3e-14 (TPGD) and 5.0e-14 (L-BFGS) eV/atom, K0 within
    4.2e-7 and 1.2e-7, V0 within 6.6e-9 and 2.0e-9 relative; bounds 1e-8
    eV/atom and 1e-5.  The scan leaves the System untouched."""
    kw = dict(f=0.04, N=6, ntol=1e-9, batched=True, n_method=n_method)
    p_j, v_j, e_j = eos_points(monkeypatch, jsys, jax_system(), **kw)
    s = torch_system()
    E0, vol0 = s.energy(), s.volume()
    p, v, e = eos_points(monkeypatch, tsys, s, **kw)
    np.testing.assert_allclose(v, v_j, rtol=1e-14)
    assert np.max(np.abs(e - e_j)) < 1e-8
    np.testing.assert_allclose(p[[0, 3]], p_j[[0, 3]], rtol=1e-5)
    assert s.energy() == E0 and s.volume() == vol0


def test_batched_tpgd_matches_jax(monkeypatch):
    check_batched_matches_jax(monkeypatch, "TPGD")
