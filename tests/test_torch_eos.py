"""The port's EOS scan (professad_tpu_torch/system.py ``eos_fit``): the
serial scan against the JAX package's, the batched scan in f32 against
f64, and every rejection of tests/test_robustness.py's batched-EOS cases.
The batched scan against the JAX package's is in test_torch_eos_batched.py
(TPGD) and test_torch_eos_lanes.py (L-BFGS, and each lane against the
serial solve of that lane)."""

import numpy as np
import pytest
import torch

import professad_tpu.system as jsys
import professad_tpu_torch.system as tsys
from eos_cases import jax_system, torch_system, eos_points

KW = dict(f=0.04, N=6)


def test_serial_matches_jax(monkeypatch):
    """Defaults (L-BFGS host loop, ntol 1e-10) at 10^3: measured per-point
    energies within 2.1e-12 eV/atom, K0 and V0 within 1.2e-7 and 2.0e-9
    relative (the 6-point fit amplifies); bounds 1e-8 eV/atom and 1e-5."""
    p_j, v_j, e_j = eos_points(monkeypatch, jsys, jax_system(), **KW)
    s = torch_system()
    p, v, e = eos_points(monkeypatch, tsys, s, **KW)
    np.testing.assert_allclose(v, v_j, rtol=1e-14)
    assert np.max(np.abs(e - e_j)) < 1e-8
    np.testing.assert_allclose(p[[0, 3]], p_j[[0, 3]], rtol=1e-5)
    # the System is left at the last volume
    assert abs(s.volume("a3") - v[-1]) < 1e-10 * v[-1]


def test_batched_f32_matches_f64():
    """dtype=torch.float32 against the f64 scan, K0 and V0 within 2e-3
    (the bound of tests/test_robustness.py).  Measured 1.7e-7 and 2.9e-9:
    the port evaluates each end point's energy in f64 (with the f32
    solver's own energies, as the JAX package fits, 2.3e-4 and 2.6e-8)."""
    kw = dict(KW, ntol=1e-7, batched=True, n_method="TPGD", n_step_size=1.0)
    p64, _ = torch_system().eos_fit(**kw)
    p32, _ = torch_system().eos_fit(dtype=torch.float32, **kw)
    np.testing.assert_allclose(p32[[0, 3]], p64[[0, 3]], rtol=2e-3)


def test_batched_rejects_ladder_terms():
    from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                            YukawaGGA, PerdewBurkeErnzerhof)
    yuk = YukawaGGA((1.0, 1.0, lambda y, s2, q: y, 1.2))
    s = torch_system((8, 8, 8), terms=[IonIon, IonElectron, Hartree,
                                       yuk.forward, PerdewBurkeErnzerhof])
    with pytest.raises(ValueError, match="ladder-based"):
        s.eos_fit(N=6, batched=True)


def test_batched_nonconverged_points_raise(capsys):
    s = torch_system((8, 8, 8))
    with pytest.raises(RuntimeError, match="converged"):
        s.eos_fit(N=6, batched=True, ntol=1e-12, n_maxiter=2)
    assert "dropping non-converged" in capsys.readouterr().out


def test_eos_rejections():
    from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                            WangTeter, PerdewBurkeErnzerhof)

    def wt(box_vecs, den):   # no fused potential under this name
        return WangTeter(box_vecs, den)

    s = torch_system((8, 8, 8))
    with pytest.raises(ValueError, match="batched"):
        s.eos_fit(N=6, dtype=torch.float32)
    with pytest.raises(ValueError, match="conv_target"):
        s.eos_fit(N=6, batched=True, conv_target="euler")
    with pytest.raises(ValueError, match="n_method"):
        s.eos_fit(N=6, batched=True, n_method="CG")
    with pytest.raises(ValueError, match="grid"):
        s.eos_fit(N=6, mesh=object())
    s2 = torch_system((8, 8, 8), terms=[IonIon, IonElectron, Hartree, wt,
                                        PerdewBurkeErnzerhof])
    with pytest.raises(ValueError, match="fused analytic"):
        s2.eos_fit(N=6, batched=True, analytic=True)
