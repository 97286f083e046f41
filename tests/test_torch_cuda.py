"""Tests of the port that need a CUDA device (marker ``cuda``): the
spectral-convolution kernel against its plain torch.fft version on the
card, its wrapper's checks and launch count, and the main path on the card.

They skip without a CUDA device.  This file imports no JAX, so on a GPU host
without JAX run it without the suite's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from professad_tpu_torch.ops import spectral_conv as sc

POT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "potentials",
                   "al.gga.recpot")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _case(shape, dtype, device, seed=3):
    rng = np.random.default_rng(seed)
    m2 = shape[2] // 2 + 1
    x = torch.tensor(rng.standard_normal(shape), dtype=dtype, device=device)
    K = torch.tensor(rng.random((shape[0], shape[1], m2)), dtype=dtype,
                     device=device)
    return x, K


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-6),
                                       (torch.float64, 1e-12)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("shape", [(18, 18, 18), (9, 15, 7), (16, 8, 10),
                                   (1, 4, 2)], ids=str)
def test_kernel_matches_reference(cuda, shape, dtype, tol):
    """Forward and backward against the plain version, with launches
    counted once per kernel call."""
    x, K = _case(shape, dtype, cuda)
    ct = torch.randn(shape, dtype=dtype, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(1))
    xk = x.clone().requires_grad_(True)
    xr = x.clone().requires_grad_(True)
    before = sc.launches
    yk = sc.spectral_conv(xk, K)
    yk.backward(ct)
    torch.cuda.synchronize()
    assert sc.launches == before + 2
    yr = sc.spectral_conv_reference(xr, K)
    yr.backward(ct)
    assert _rel(yk.detach(), yr.detach()) < tol
    assert _rel(xk.grad, xr.grad) < tol


@pytest.mark.cuda
def test_uniform_field_stays_exact(cuda):
    x = torch.full((24, 24, 24), 0.0296, dtype=torch.float32, device=cuda)
    _, K = _case((24, 24, 24), torch.float32, cuda)
    y = sc.spectral_conv(x, K)
    assert bool((y == y.reshape(-1)[0]).all())


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, K = _case((8, 8, 8), torch.float32, cuda)
    with pytest.raises(ValueError, match="requires_grad"):
        sc.spectral_conv(x, K.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="K must be"):
        sc.spectral_conv(x, K[:, :, :4].contiguous())
    with pytest.raises(ValueError, match="K must be"):
        sc.spectral_conv(x, K.double())


@pytest.mark.cuda
def test_golden_energy_on_the_card(cuda):
    """PROFESS-4 golden fcc-Al energy (18^3, f64) through the main path on
    the card: every dedicated convolution goes through the kernel."""
    from professad_tpu_torch import System
    from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                            WangTeter, PerdewBurkeErnzerhof)
    cell = 4.050 * np.array([[0.5, 0.5, 0.0], [0.0, 0.5, 0.5],
                             [0.5, 0.0, 0.5]])
    s = System(cell, (18, 18, 18), [["Al", POT, np.zeros((1, 3))]],
               [IonIon, IonElectron, Hartree, WangTeter,
                PerdewBurkeErnzerhof], units="a", coord_type="fractional",
               device=cuda, dtype=torch.float64)
    before = sc.launches
    n_it, conv = s.optimize_density(ntol=1e-7, n_method="TPGD",
                                    analytic=True, precondition=True,
                                    n_step_size=1.0, skip_iters=2)
    assert conv
    assert sc.launches - before >= 3 * n_it
    assert abs(s.energy("eV") - (-57.183329401794985)) < 1e-4
