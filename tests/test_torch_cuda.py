"""Tests of the port that need a CUDA device (marker ``cuda``): the
spectral-convolution and Stockham kernels against their plain torch.fft
versions on the card, their wrappers' checks and launch counts, and the
density paths on the card.

They skip without a CUDA device.  This file imports no JAX, so on a GPU host
without JAX run it without the suite's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from professad_tpu_torch.ops import spectral_conv as sc
from professad_tpu_torch.ops import vpufft as vf

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
                                   (1, 4, 2), (31, 37, 45), (61, 18, 7),
                                   (45, 45, 45), (128, 128, 128)], ids=str)
def test_kernel_matches_reference(cuda, shape, dtype, tol):
    """Forward and backward against the plain version, with launches
    counted once per kernel call: composite, odd and prime axes (a prime
    axis runs as one generic stage) and the main path's 128^3."""
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
                                    n_step_size=1.0, skip_iters=2,
                                    jit_loop=True)
    assert conv
    assert sc.launches - before >= 3 * n_it
    assert abs(s.energy("eV") - (-57.183329401794985)) < 1e-4
    # the default path (host-loop L-BFGS, autograd gradient) on the card
    s.initialize_density()
    n_it, conv = s.optimize_density(ntol=1e-7)
    assert conv
    assert abs(s.energy("eV") - (-57.183329401794985)) < 1e-4


@pytest.mark.cuda
def test_system_defaults_to_the_card(cuda):
    from professad_tpu_torch import System
    from professad_tpu_torch.models import IonElectron, ThomasFermi
    s = System(4.05 * np.eye(3), (8, 8, 8), [["Al", POT, np.zeros((1, 3))]],
               [IonElectron, ThomasFermi], units="a",
               coord_type="fractional")
    assert s.density().device == torch.device("cuda", 0)


SUBLANE = {
    "fft_sublane": 2, "ifft_sublane": 2, "fft_sublane_real": 1,
    "ifft_sublane_real_out": 2, "sublane_conv": 3,
}
KEY = {"ifft_sublane": "fft_sublane", "ifft_mid": "fft_mid"}


def _planes(shape, count, device, seed=5):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                         device=device) for _ in range(count)]


def _rel_all(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return max(_rel(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SUBLANE))
@pytest.mark.parametrize("shape", [(32, 256), (16, 256), (128, 8320),
                                   (512, 100), (8, 3), (1, 5)], ids=str)
def test_stockham_sublane_matches_reference(cuda, name, shape):
    """Each axis-0 entry against its torch.fft version (rel 1e-6), tails
    included, with one launch counted per call."""
    args = _planes(shape, SUBLANE[name], cuda)
    key = KEY.get(name, name)
    before = vf.launches[key]
    got = getattr(vf, name)(*args)
    torch.cuda.synchronize()
    assert vf.launches[key] == before + 1
    assert _rel_all(got, getattr(vf, name + "_reference")(*args)) < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fft_mid", "ifft_mid"])
@pytest.mark.parametrize("shape", [(16, 16, 16), (3, 8, 5), (4, 256, 40)],
                         ids=str)
def test_stockham_mid_matches_reference(cuda, name, shape):
    args = _planes(shape, 2, cuda)
    before = vf.launches["fft_mid"]
    got = getattr(vf, name)(*args)
    torch.cuda.synchronize()
    assert vf.launches["fft_mid"] == before + 1
    assert _rel_all(got, getattr(vf, name + "_reference")(*args)) < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 64])
def test_conv3_bfly_matches_fftn(cuda, n):
    """The composition over the kernels against ifftn(K fftn(x)).real for
    a Hermitian-even K given in (z, y, x) layout."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((n, n, n)).astype(np.float32)
    Kf = rng.standard_normal((n, n, n))
    idx = (-np.arange(n)) % n
    Kf = 0.5 * (Kf + Kf[np.ix_(idx, idx, idx)])
    k_t = np.ascontiguousarray(np.transpose(Kf, (2, 1, 0)), np.float32)
    y = vf.conv3_bfly(torch.tensor(x, device=cuda),
                      torch.tensor(k_t, device=cuda))
    ref = np.fft.ifftn(Kf * np.fft.fftn(x)).real
    assert np.abs(y.cpu().numpy() - ref).max() / np.abs(ref).max() < 2e-6


@pytest.mark.cuda
def test_stockham_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    a, b = _planes((16, 64), 2, cuda)
    with pytest.raises(ValueError, match="require grad"):
        vf.fft_sublane(a.clone().requires_grad_(True), b)
    with pytest.raises(ValueError, match="contiguous"):
        vf.fft_sublane(a.t().contiguous().t(), b)
    with pytest.raises(ValueError, match="float32"):
        vf.fft_sublane(a.double(), b.double())
    with pytest.raises(ValueError, match="power-of-two"):
        vf.fft_mid(*_planes((2, 12, 4), 2, cuda))
    with pytest.raises(ValueError, match="shared memory"):
        vf.fft_sublane_real(_planes((8192, 2), 1, cuda)[0])
