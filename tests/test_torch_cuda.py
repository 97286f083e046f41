"""Tests of the port that need a CUDA device (marker ``cuda``): the
spectral-convolution and Stockham kernels against their plain torch.fft
versions on the card, their wrappers' checks and launch counts, the
density paths, the fused potentials of every ported functional and the
geometry relaxation on the card against the same calls on the CPU, the
fused sweeps of the functionals with ladders and kernel tables, the
second derivatives, PME, the radial preconditioner kernel, the TPGD
keywords and the grid helpers against the CPU, and the mesh paths on one
NCCL rank (world size 1: NCCL takes one rank per card) against the serial
paths on the card.

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
LI_POT = os.path.join(os.path.dirname(POT), "li.gga.recpot")
MG_POT = os.path.join(os.path.dirname(POT), "mg.gga.recpot")


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


def _functionals():
    from professad_tpu_torch import models as tm

    def pg(preset):
        f = tm.PauliGaussian()
        getattr(f, preset)()
        return f
    return {
        "Perrot": tm.Perrot, "SmargiassiMadden": tm.SmargiassiMadden,
        "WangGovindCarter98": tm.WangGovindCarter98,
        "WTSF_1+x": tm.WangTeterStyleFunctional(
            (0.8, 0.7, lambda x: 1.0 + x)),
        "WTSF_exp": tm.WangTeterStyleFunctional(
            (5.0 / 6.0, 5.0 / 6.0, torch.exp)),
        "vWGTF1": tm.vWGTF1, "vWGTF2": tm.vWGTF2,
        "LuoKarasievTrickey": tm.LuoKarasievTrickey,
        "PG1": pg("set_PG1"), "PGS": pg("set_PGS"),
        "PGSL025": pg("set_PGSL025"), "PGSLr": pg("set_PGSLr"),
        "PerdewZunger": tm.PerdewZunger, "PerdewWang": tm.PerdewWang,
        "Chachiyo": tm.Chachiyo,
    }


FUNCTIONALS = ["Perrot", "SmargiassiMadden", "WangGovindCarter98",
               "WTSF_1+x", "WTSF_exp", "vWGTF1", "vWGTF2",
               "LuoKarasievTrickey", "PG1", "PGS", "PGSL025", "PGSLr",
               "PerdewZunger", "PerdewWang", "Chachiyo"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_fused_potential_on_the_card(cuda, name, dtype):
    """value_and_potential on the card (the WT family's kernel through
    spectral_conv) against the f64 call on the CPU: f64 at rel 1e-12; f32
    at rel 5e-6 for E and 5e-5 of max |dE/dn| (the CPU's own f32 sweep is
    within 6.4e-7 and 8.2e-6 of f64 at this size)."""
    from professad_tpu_torch.models import potentials as tpot
    rng = np.random.default_rng(7)
    shape = (18, 18, 18)
    box = 7.0 * np.eye(3) + 0.2 * rng.standard_normal((3, 3))
    den = 0.01 + 0.02 * rng.random(shape)
    term = _functionals()[name]
    E_ref, p_ref = tpot.value_and_potential(
        [term], torch.tensor(box), torch.tensor(den),
        torch.zeros(shape, dtype=torch.float64))
    if isinstance(term, torch.nn.Module):
        term = term.to(cuda)
    z = dict(dtype=dtype, device=cuda)
    E, p = tpot.value_and_potential(
        [term], torch.tensor(box, **z), torch.tensor(den, **z),
        torch.zeros(shape, **z))
    torch.cuda.synchronize()
    tol_E, tol_p = (1e-12, 1e-12) if dtype == torch.float64 else (5e-6, 5e-5)
    assert p.dtype == dtype and p.device == cuda
    assert abs(float(E) - float(E_ref)) <= tol_E * abs(float(E_ref))
    assert _rel(p.double().cpu(), p_ref) <= tol_p


def _li_system(device):
    from professad_tpu_torch import System
    from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                            SmargiassiMadden,
                                            PerdewBurkeErnzerhof)
    box = 3.48 * np.array([[1.0, 0.02, 0.0], [0.0, 1.0, 0.03],
                           [0.01, 0.0, 1.0]])
    frac = np.array([[0.12, 0.1, 0.11], [0.61, 0.59, 0.62]])
    return System(box, (12, 12, 12), [["Li", LI_POT, frac]],
                  [IonIon, IonElectron, Hartree, SmargiassiMadden,
                   PerdewBurkeErnzerhof], units="a", coord_type="fractional",
                  device=device, dtype=torch.float64)


@pytest.mark.cuda
def test_geometry_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """Three ions + cell steps of bcc Li (12^3, f64) with the analytic
    preconditioned TPGD density path on the card and on the CPU: the
    fractional coordinates and the box after each step agree at rtol
    1e-9.  On the card the density re-optimizations launch spectral_conv
    (>= 3 a density iteration), and no call reaches the kernel with a
    kernel or field that requires grad, so the dK guard never fires:
    the geometry gradient goes through the torch.fft term bodies."""
    calls = []
    kernel = sc.spectral_conv

    def watched(x, K):
        calls.append(x.requires_grad or K.requires_grad)
        return kernel(x, K)
    monkeypatch.setattr(sc, "spectral_conv", watched)

    den_opt = dict(n_method="TPGD", jit_loop=True, analytic=True,
                   precondition=True, n_step_size=1.0, skip_iters=2,
                   ntol=1e-9)
    runs = {}
    for dev in (torch.device("cpu"), cuda):
        s = _li_system(dev)
        log, iters = [], []
        run = s.optimize_density

        def wrapped(s=s, log=log, iters=iters, run=run, **kw):
            log.append((s._frac_ion_coords.cpu().numpy(),
                        s._box_vecs.cpu().numpy()))
            n_it, conv = run(**kw)
            iters.append(n_it)
            assert conv
            return n_it, conv
        s.optimize_density = wrapped
        before = sc.launches
        assert s.optimize_geometry(ftol=0.02, stol=0.003, g_maxiter=3,
                                   **den_opt) is False
        torch.cuda.synchronize()
        runs[dev.type] = (log, iters, sc.launches - before)
    (log_c, _, launches_c), (log_g, iters_g, launches_g) = \
        runs["cpu"], runs["cuda"]
    assert launches_c == 0 and launches_g >= 3 * sum(iters_g)
    assert calls and not any(calls)
    for (fc, bc), (fg, bg) in zip(log_c, log_g):
        assert np.max(np.abs(fg - fc)) <= 1e-9 * np.max(np.abs(fc))
        assert np.max(np.abs(bg - bc)) <= 1e-9 * np.max(np.abs(bc))


# spectral_conv calls of one fused sweep: the vW Laplacian plus the term's
# fixed-kernel convolutions (the ladder terms convolve through torch.fft)
NONLOCAL = {"HuangCarter": 1, "RevisedHuangCarter": 1, "YukawaGGA-yuk1": 1,
            "YukawaGGA-yuk4": 1, "MiGenovaPavanello": 2,
            "WangGovindCarter99": 13, "FoleyMadden": 2, "KGAP": 3,
            "XuWangMa": 5}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("shape", [(16, 16, 16), (33, 33, 33)], ids=str)
@pytest.mark.parametrize("name", list(NONLOCAL))
def test_nonlocal_potential_on_the_card(cuda, monkeypatch, name, shape,
                                        dtype):
    """Each non-local functional's fused sweep on the card against the f64
    sweep on the CPU (f64 rel 1e-12; f32 rel 5e-6 for E and 5e-5 of max
    |dE/dn|), with trainable parameters that require grad: every call
    reaches spectral_conv with a constant kernel, and the term's own
    convolutions launch it.  The terms are chip_smoke.py's."""
    from chip_smoke import nonlocal_term
    from professad_tpu_torch.models import potentials as tpot
    rng = np.random.default_rng(7)
    box = 7.0 * np.eye(3) + 0.2 * rng.standard_normal((3, 3))
    den = 0.01 + 0.02 * rng.random(shape)
    results = []
    for dev, dt in ((torch.device("cpu"), torch.float64), (cuda, dtype)):
        term = nonlocal_term(name)
        owner = getattr(term, "__self__", term)
        z = dict(dtype=dt, device=dev)
        b, d = torch.tensor(box, **z), torch.tensor(den, **z)
        if isinstance(owner, torch.nn.Module):
            owner.to(dev).param_grad(True)
            if hasattr(owner, "prepare"):
                owner.prepare(b, d)
        seen = []
        kernel = sc.spectral_conv

        def watched(x, K):
            seen.append(K.requires_grad)
            return kernel(x, K)
        monkeypatch.setattr(sc, "spectral_conv", watched)
        before = sc.launches
        results.append(tpot.value_and_potential(
            [term], b, d, torch.zeros(shape, **z)))
        torch.cuda.synchronize()
        monkeypatch.setattr(sc, "spectral_conv", kernel)
        assert seen and not any(seen)
        launched = sc.launches - before
    assert launched == NONLOCAL[name]
    (E_ref, p_ref), (E, p) = results
    tol_E, tol_p = (1e-12, 1e-12) if dtype == torch.float64 else (5e-6, 5e-5)
    assert p.dtype == dtype and p.device == cuda
    assert abs(float(E) - float(E_ref)) <= tol_E * abs(float(E_ref))
    assert _rel(p.double().cpu(), p_ref) <= tol_p


def _second_system(device, shape=(16, 16, 16)):
    from professad_tpu_torch import System
    from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                            WangTeter, PerdewBurkeErnzerhof)
    frac = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5],
                     [0.0, 0.48, 0.53]])
    return System(4.05 * np.eye(3), shape, [["Al", POT, frac]],
                  [IonIon, IonElectron, Hartree, WangTeter,
                   PerdewBurkeErnzerhof], units="a", coord_type="fractional",
                  device=device)


@pytest.mark.cuda
def test_second_derivatives_card_vs_cpu(cuda):
    """K, C and Phi on the card (the CG preconditioner applied by the
    kernel) against the same getters on the CPU, one f64 state at 16^3,
    rtol 1e-10."""
    cpu = _second_system("cpu")
    cpu.optimize_density(ntol=1e-10)
    card = _second_system(cuda)
    card.set_density(cpu.density().to(cuda))
    before = sc.launches
    got = (card.bulk_modulus(), card.elastic_constants().cpu(),
           card.force_constants([3], "Ha/b2").cpu())
    assert sc.launches > before
    ref = (cpu.bulk_modulus(), cpu.elastic_constants(),
           cpu.force_constants([3], "Ha/b2"))
    assert abs(got[0] - ref[0]) <= 1e-10 * abs(ref[0])
    for a, b in zip(got[1:], ref[1:]):
        assert _rel(a, b) <= 1e-10


@pytest.mark.cuda
def test_structure_factor_spline_card_vs_cpu(cuda):
    """PME on the card (f64 index_add with atomics: a tolerance, not bit
    equality) against the CPU, rtol 1e-12."""
    from professad_tpu_torch.models import ions
    rng = np.random.default_rng(7)
    box = 7.0 * np.eye(3) + 0.3 * rng.random((3, 3))
    coords = rng.random((41, 3)) @ box
    out = [ions.structure_factor_spline(
        torch.tensor(box, dtype=torch.float64, device=d), (18, 20, 14),
        torch.tensor(coords, dtype=torch.float64, device=d), 10).cpu()
        for d in (cuda, "cpu")]
    assert _rel(out[0], out[1]) <= 1e-12


@pytest.mark.cuda
def test_radial_kernel_card_vs_cpu(cuda):
    """The radial preconditioner kernel on the card against the CPU,
    (16, 20, 24), f64, rtol 1e-12."""
    out = []
    for d in (cuda, "cpu"):
        s = _second_system(d, shape=(16, 20, 24))
        out.append(s._exact_precond_kernel_radial(
            s._box_vecs, float(s.electron_count())).cpu())
    assert _rel(out[0], out[1]) <= 1e-12


def _batch_case(B, shape, dtype, device, seed=7):
    """x and one K per lane.  Each K is the half spectrum of a real even
    kernel, K(-k) = K(k), as every physical kernel is: a c2r transform of
    a spectrum that is not Hermitian on the kz = 0 and Nyquist planes is
    not defined, and cuFFT's batched f32 plan at 128^3 treats such input
    unlike its 3-D plan (3.6e-2 apart on the card)."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((B,) + shape), dtype=dtype,
                     device=device)
    Kf = rng.random((B,) + shape)
    mirror = np.ix_(*[(-np.arange(n)) % n for n in shape])
    Kf = 0.5 * (Kf + Kf[(slice(None),) + mirror])
    K = torch.tensor(np.ascontiguousarray(Kf[..., : shape[2] // 2 + 1]),
                     dtype=dtype, device=device)
    return x, K


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [False, True], ids=["per_lane", "shared"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("B,shape", [(3, (128, 128, 128)), (5, (27, 27, 39)),
                                     (4, (9, 15, 7))], ids=str)
def test_batched_kernel_matches_reference(cuda, B, shape, dtype, tol,
                                          shared):
    """A (B, n0, n1, n2) batch in ONE kernel call (one launch counted)
    against the plain version, and lane by lane against the 3-D kernel
    call, with one K per lane or one shared."""
    x, K = _batch_case(B, shape, dtype, cuda)
    K = K[0] if shared else K
    before = sc.launches
    y = sc.spectral_conv(x, K)
    torch.cuda.synchronize()
    assert sc.launches == before + 1
    assert _rel(y, sc.spectral_conv_reference(x, K)) < tol
    for b in range(B):
        yb = sc.spectral_conv(x[b], K if shared else K[b])
        assert _rel(y[b], yb) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)],
                         ids=["f32", "f64"])
def test_vmap_rule_forward_and_backward(cuda, dtype, tol):
    """torch.func.vmap of the 3-D call launches the batched kernel once
    (K batched or shared); its backward, by autograd through the vmapped
    call and by torch.func.grad under vmap, is the same operator."""
    x, K = _batch_case(4, (16, 12, 10), dtype, cuda)
    ct = torch.randn_like(x)
    ref = sc.spectral_conv_reference(x, K)
    xv = x.clone().requires_grad_(True)
    before = sc.launches
    y = torch.func.vmap(sc.spectral_conv)(xv, K)
    assert sc.launches == before + 1
    assert _rel(y.detach(), ref) < tol
    y.backward(ct)
    assert sc.launches == before + 2
    assert _rel(xv.grad, sc.spectral_conv_reference(ct, K)) < tol
    before = sc.launches
    ys = torch.func.vmap(sc.spectral_conv, in_dims=(0, None))(x, K[0])
    assert sc.launches == before + 1
    assert _rel(ys, sc.spectral_conv_reference(x, K[0])) < tol
    # d/dv (|A v|^2 / 2) = A (A v): forward and backward batched
    g = torch.func.vmap(torch.func.grad(
        lambda v, k: 0.5 * (sc.spectral_conv(v, k) ** 2).sum()))(x, K)
    want = sc.spectral_conv_reference(ref, K)
    assert _rel(g, want) < 10 * tol


@pytest.mark.cuda
def test_batched_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, K = _batch_case(3, (8, 8, 8), torch.float32, cuda)
    with pytest.raises(ValueError, match="requires_grad"):
        sc.spectral_conv(x, K.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="K must be"):
        sc.spectral_conv(x, K[:2])
    with pytest.raises(ValueError, match="65535"):
        sc.spectral_conv(torch.zeros((8200, 8, 2, 2), device=cuda),
                         torch.zeros((8, 2, 2), device=cuda))


def _fcc_al(device, shape=(16, 16, 16)):
    from professad_tpu_torch import System
    from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                            WangTeter, PerdewBurkeErnzerhof)
    cell = 4.050 * np.array([[0.5, 0.5, 0.0], [0.0, 0.5, 0.5],
                             [0.5, 0.0, 0.5]])
    return System(cell, shape, [["Al", POT, np.zeros((1, 3))]],
                  [IonIon, IonElectron, Hartree, WangTeter,
                   PerdewBurkeErnzerhof], units="a", coord_type="fractional",
                  device=device, dtype=torch.float64)


_DEN_OPT = dict(ntol=1e-9, n_method="TPGD", analytic=True, precondition=True,
                n_step_size=1.0, skip_iters=2, jit_loop=True)


@pytest.mark.cuda
def test_set_device_to_the_card(cuda):
    """Built on the CPU, moved, optimized on the card: the energy of a
    System built on the card, within 1e-10 relative."""
    s = _fcc_al("cpu")
    s.set_device("cuda")
    assert s.density().device == cuda and s._charges.device == cuda
    assert all(t.device == cuda for ks, pot, _ in s._recpot_tables
               for t in (ks, pot))
    before = sc.launches
    s.optimize_density(**_DEN_OPT)
    assert sc.launches > before
    ref = _fcc_al(cuda)
    ref.optimize_density(**_DEN_OPT)
    assert abs(s.energy() - ref.energy()) < 1e-10 * abs(ref.energy())


@pytest.mark.cuda
def test_batched_eos_scan_on_the_card(cuda):
    """16^3, N = 6, TPGD with the fused gradient: every lane against the
    serial solve of that lane on the card (rel 1e-10 in f64); B1 launches
    once per site and iteration whatever the lane count (the first
    evaluation's vW and WT, then the preconditioner, vW and WT a step)."""
    s = _fcc_al(cuda)
    vs = s.volume("a3") * np.linspace(0.95, 1.05, 6)
    norm = (s.lattice_vectors("a") / s.volume("a3") ** (1 / 3)).cpu().numpy()
    box, vext, chi, _ = s._eos_points(vs, norm)
    kw = dict(n_method="TPGD", lr=1.0, ntol=1e-9, conv_count=3,
              max_iter=300, analytic=True)
    before = sc.launches
    f, conv, its = s._eos_solve_fn(**kw)(chi, box, vext)
    assert sc.launches - before == 3 * max(its) + 2
    serial = s._eos_solve_fn(batched=False, **kw)
    for b in range(len(vs)):
        f1, conv1, _ = serial(chi[b], box[b], vext[b])
        assert conv[b] and conv1
        assert abs(float(f[b]) - float(f1)) < 1e-10 * abs(float(f1))
    params, _ = s.eos_fit(f=0.05, N=6, batched=True, n_method="TPGD",
                          analytic=True, ntol=1e-9)
    assert np.all(np.isfinite(params))


# ------------------------- the mesh paths on one NCCL rank ----------------

@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A ("batch", "grid") mesh of shape (1, 1) over an NCCL process group
    of world size 1 on cuda:0 (file:// rendezvous), destroyed after the
    module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from professad_tpu_torch.parallel import init_process_group, make_mesh
    rdv = tmp_path_factory.mktemp("nccl") / "rdv"
    init_process_group(0, 1, f"file://{rdv}", device="cuda:0")
    yield make_mesh(1)
    dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-6),
                                       (torch.float64, 1e-12)],
                         ids=["f32", "f64"])
def test_pencil_mode_never_launches_the_kernel(nccl_mesh, dtype, tol):
    """Under pencil_mode spectral_convolution composes the pencil
    transforms (torch.fft and NCCL) and does not launch spectral_conv; the
    serial call still launches it, and both agree."""
    from professad_tpu_torch.ops import grid
    cuda = torch.device("cuda", 0)
    x, K = _case((32, 24, 20), dtype, cuda)
    before = sc.launches
    with grid.pencil_mode(nccl_mesh):
        y = grid.spectral_convolution(K, x, x.shape)
    torch.cuda.synchronize()
    assert sc.launches == before
    y_serial = grid.spectral_convolution(K, x, x.shape)
    torch.cuda.synchronize()
    assert sc.launches == before + 1
    assert _rel(y, y_serial) < tol


@pytest.mark.cuda
def test_pencil_transforms_and_collectives_nccl(nccl_mesh):
    from professad_tpu_torch.parallel import (pfft, grid_group, psum,
                                              rank_share, all_to_all)
    group = grid_group(nccl_mesh)[0]
    cuda = torch.device("cuda", 0)
    x, _ = _case((16, 12, 10), torch.float64, cuda)
    X = pfft.prfftn(x, group)
    assert _rel(X, torch.fft.rfftn(x)) < 1e-12
    assert _rel(pfft.pirfftn(X, x.shape, group), x) < 1e-12
    # a uniform f32 field stays uniform (tests/test_parallel_generic.py's
    # DC-split check; the card's f32 sum of it is not exact)
    u = torch.full((16, 12, 10), 0.0296, dtype=torch.float32, device=cuda)
    rt = pfft.pirfftn_dc(pfft.prfftn_dc(u, group), u.shape, group)
    assert bool((rt == rt.reshape(-1)[0]).all())
    assert abs(float(rt.reshape(-1)[0]) - 0.0296) < 1e-6 * 0.0296
    z = torch.randn(4, 6, dtype=torch.complex128, device=cuda)
    assert bool((all_to_all(z, 1, 0, group) == z).all())
    a = x.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(rank_share(psum((a * a).sum(), group),
                                          group), a)
    assert _rel(g, 2 * x) < 1e-15


def _li2_card(shape, dtype=torch.float64):
    from professad_tpu_torch import System
    from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                            WangTeter, PerdewBurkeErnzerhof)
    L = 6.96
    return System(L * np.eye(3), shape,
                  [["Li", LI_POT, L * np.array([[0.02, 0.05, 0.0],
                                                [0.5, 0.5, 0.47]])]],
                  [IonIon, IonElectron, Hartree, WangTeter,
                   PerdewBurkeErnzerhof], units="b", device="cuda:0",
                  dtype=dtype)


MESH_KW = dict(ntol=1e-9, jit_loop=True, precondition=True, n_step_size=1.0,
               n_method="TPGD", skip_iters=2, analytic=True)


@pytest.mark.cuda
@pytest.mark.parametrize("method,analytic", [("TPGD", True), ("LBFGS", True),
                                             ("TPGD", False)],
                         ids=["tpgd", "lbfgs", "autodiff"])
def test_mesh_optimize_density_card_vs_serial(nccl_mesh, method, analytic):
    """optimize_density(mesh=) at 32^3 f64 on the card against the serial
    path (L-BFGS checking every iteration on both, as the mesh path's
    default): energy, density, forces and stress."""
    kw = dict(MESH_KW, n_method=method, analytic=analytic, block=1)
    ser = _li2_card((32, 32, 32))
    ser.optimize_density(**kw)
    msh = _li2_card((32, 32, 32))
    before = sc.launches
    msh.optimize_density(mesh=nccl_mesh, **kw)
    torch.cuda.synchronize()
    assert sc.launches == before
    assert msh._mesh is nccl_mesh
    assert abs(msh.energy() - ser.energy()) <= 1e-12 * abs(ser.energy())
    assert _rel(msh.density(), ser.density()) < 1e-10
    assert _rel(msh.forces(), ser.forces()) < 1e-10
    assert _rel(msh.stress(), ser.stress()) < 1e-10


@pytest.mark.cuda
def test_mesh_second_derivatives_card(nccl_mesh):
    s = _li2_card((16, 16, 16))
    s.optimize_density(**dict(MESH_KW, ntol=1e-11))
    ref = (s.pressure(), s.bulk_modulus(), s.force_constants([0]))
    s.set_mesh(nccl_mesh)
    got = (s.pressure(), s.bulk_modulus(), s.force_constants([0]))
    assert abs(got[0] - ref[0]) <= 1e-10 * abs(ref[0])
    assert abs(got[1] - ref[1]) <= 1e-10 * abs(ref[1])
    assert _rel(got[2], ref[2]) < 1e-10


@pytest.mark.cuda
def test_mesh_f32_main_path_card(nccl_mesh):
    """The f32 fast tier on the mesh lands where the serial f32 path does
    (within the f32 bound of tests/test_f32_accuracy.py, 2e-5 eV/atom) in
    as many iterations, give or take 2."""
    ser = _li2_card((32, 32, 32), torch.float32)
    n_ser, _ = ser.optimize_density(**dict(MESH_KW, ntol=1e-7))
    msh = _li2_card((32, 32, 32), torch.float32)
    n_msh, conv = msh.optimize_density(mesh=nccl_mesh,
                                       **dict(MESH_KW, ntol=1e-7))
    assert conv and abs(n_msh - n_ser) <= 2
    assert abs(msh.energy("eV") - ser.energy("eV")) / 2 < 2e-5


@pytest.mark.cuda
def test_mesh_eos_batch_card(nccl_mesh):
    """eos_fit on a batch mesh (every volume on this rank, the results
    all-gathered) equals the serial batched scan: cubic fcc Al, WT + PBE,
    16^3."""
    from professad_tpu_torch import System
    from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                            WangTeter, PerdewBurkeErnzerhof)
    from professad_tpu_torch.parallel import make_mesh

    def fcc():
        frac = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5],
                         [0.0, 0.5, 0.5]])
        return System(4.05 * np.eye(3), (16, 16, 16), [["Al", POT, frac]],
                      [IonIon, IonElectron, Hartree, WangTeter,
                       PerdewBurkeErnzerhof], units="a",
                      coord_type="fractional", device="cuda:0")

    kw = dict(f=0.05, N=5, ntol=1e-9, n_method="TPGD", n_step_size=1.0,
              analytic=True, batched=True)
    p_ser, _ = fcc().eos_fit(**kw)
    p_msh, _ = fcc().eos_fit(mesh=make_mesh(1, batch=1), **kw)
    assert np.allclose(p_msh, p_ser, rtol=1e-8)


def _tpgd_run(device, stag_k, track_best, n=32):
    """tpgd_minimize on the main path's cell with one ion displaced
    (4-atom cubic fcc Al, WT + PBE, f64, the fused gradient and the exact
    preconditioner) from the uniform start."""
    from professad_tpu_torch.ops import solvers
    from professad_tpu_torch.ops.grid import safe_sqrt
    s = _second_system(device, (n, n, n))
    N = float(s._N_elec)
    box, v_ext = s._box_vecs, s._v_ext
    st, it, conv = solvers.tpgd_minimize(
        lambda x: s._chi_value_and_grad_analytic(x, box, v_ext, N),
        safe_sqrt(s._uniform_density()), lr=1.0, ntol=1e-9, conv_count=3,
        max_iter=200, f_scale=27.211386245988, skip_iters=2,
        apply_H0=s._apply_spectral(s._exact_precond_kernel(box, N)),
        stag_k=stag_k, track_best=track_best)
    return float(st.f), it, conv, st.x.cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("stag_k,track_best", [(6, False), (3, True)])
def test_tpgd_keywords_card_vs_cpu(cuda, stag_k, track_best):
    """``stag_k`` and ``track_best`` at 32^3 f64: the card (the kernel
    applies the preconditioner, WT and vW) against the same call on the
    CPU (their plain version), the energy within 1e-10."""
    before = sc.launches
    E, it, conv, x = _tpgd_run(cuda, stag_k, track_best)
    assert sc.launches - before >= 3 * it
    E_cpu, it_cpu, conv_cpu, x_cpu = _tpgd_run("cpu", stag_k, track_best)
    assert conv and conv_cpu and abs(it - it_cpu) <= 1
    assert abs(E - E_cpu) <= 1e-10 * abs(E_cpu)
    assert _rel(x, x_cpu) < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,ctype", [(torch.float32, torch.complex64),
                                         (torch.float64, torch.complex128)],
                         ids=["f32", "f64"])
def test_grid_helpers_on_the_card(cuda, dtype, ctype):
    """``expi`` and ``wavenumbers`` on the card against the CPU, in the
    input's dtype."""
    from professad_tpu_torch.ops import grid
    rng = np.random.default_rng(4)
    theta = torch.tensor(rng.uniform(-30.0, 30.0, (9, 15, 7)), dtype=dtype)
    got = grid.expi(theta.to(cuda))
    assert got.dtype == ctype and got.device.type == "cuda"
    tol = 1e-6 if dtype == torch.float32 else 1e-15
    assert float((got.cpu() - grid.expi(theta)).abs().max()) <= tol
    box = torch.tensor(7.3 * np.eye(3) + 0.3 * rng.standard_normal((3, 3)),
                       dtype=dtype)
    k = grid.wavenumbers(box.to(cuda), (16, 12, 10))
    assert k.dtype == dtype and k.shape == (16, 12, 6)
    assert _rel(k.cpu(), grid.wavenumbers(box, (16, 12, 10))) <= tol


def _wt_exp_system(device, dtype, n=32):
    """4-atom fcc Al, one ion displaced, WT-exp + PBE at n^3."""
    from professad_tpu_torch import System
    from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                            WangTeterStyleFunctional,
                                            PerdewBurkeErnzerhof)
    frac = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5],
                     [0.0, 0.48, 0.53]])
    wt = WangTeterStyleFunctional((5.0 / 6.0, 5.0 / 6.0, torch.exp))
    return System(4.05 * np.eye(3), (n, n, n), [["Al", POT, frac]],
                  [IonIon, IonElectron, Hartree, wt.to(device).forward,
                   PerdewBurkeErnzerhof], units="a", coord_type="fractional",
                  device=device, dtype=dtype)


def _graph_solve(s, capturable, stag_k=6, track_best=True):
    """tpgd_minimize on the System's fused analytic path from the uniform
    start, as ``optimize_density(jit_loop=True, analytic=True)`` calls it;
    returns (state, iterations, converged, spectral_conv calls, graph
    replays)."""
    from professad_tpu_torch.ops import solvers
    from professad_tpu_torch.ops.grid import safe_sqrt
    dt = s._dtype
    box, v_ext, N = s._box_vecs.to(dt), s._v_ext.to(dt), float(s._N_elec)
    vg, _ = s._analytic_solve_fn(box, v_ext, N, None, "TPGD")
    M = s._apply_spectral(s._cell_precond_kernel(dt))
    calls, replays = sc.launches, solvers.graph_replays
    st, it, conv = solvers.tpgd_minimize(
        vg, safe_sqrt(s._uniform_density()).to(dt), lr=1.0, ntol=1e-9,
        conv_count=3, max_iter=300, f_scale=27.211386245988, skip_iters=2,
        apply_H0=M, stag_k=stag_k, track_best=track_best,
        capturable=capturable)
    torch.cuda.synchronize()
    return (st, it, conv, sc.launches - calls,
            solvers.graph_replays - replays)


@pytest.mark.cuda
@pytest.mark.parametrize("stag_k,track_best", [(6, True), (2, True),
                                               (2, False)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_tpgd_graph_is_bitwise_the_eager_loop(cuda, dtype, stag_k,
                                              track_best):
    """The TPGD iterations as CUDA graph replays against the eager loop on
    the card, WT-exp + PBE at 32^3: bitwise x, f and g, the same
    iteration count, every iteration after the first a replay, and
    ``spectral_conv.launches`` advanced by the same count."""
    s = _wt_exp_system(cuda, dtype)
    st_e, it_e, conv_e, calls_e, rep_e = _graph_solve(s, False, stag_k,
                                                      track_best)
    st_g, it_g, conv_g, calls_g, rep_g = _graph_solve(s, True, stag_k,
                                                      track_best)
    assert rep_e == 0 and rep_g == it_g - 1 > 0
    assert (it_g, conv_g) == (it_e, conv_e)
    assert calls_g == calls_e >= 3 * it_e
    assert torch.equal(st_g.x, st_e.x) and torch.equal(st_g.f, st_e.f)
    assert torch.equal(st_g.g, st_e.g)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_optimize_density_graph_on_and_off(cuda, monkeypatch, dtype):
    """``optimize_density`` on the card (TPGD, jit_loop, analytic) takes
    the graph by itself and leaves bitwise the density and energy of the
    same call with the graph kept off, and no more memory allocated: the
    graph's buffers are released when it returns."""
    from professad_tpu_torch.ops import solvers
    kw = dict(ntol=1e-9, n_method="TPGD", n_step_size=1.0, skip_iters=2,
              jit_loop=True, precondition=True, from_uniform=True,
              analytic=True)
    s = _wt_exp_system(cuda, dtype)
    rep = solvers.graph_replays
    n_on, conv_on = s.optimize_density(**kw)
    den_on, E_on = s.density().clone(), s.energy()
    torch.cuda.synchronize()
    held_on = torch.cuda.memory_allocated()
    assert conv_on and solvers.graph_replays - rep == n_on - 1
    monkeypatch.setattr(solvers, "_graph_engages", lambda *a: False)
    rep = solvers.graph_replays
    n_off, _ = s.optimize_density(**kw)
    torch.cuda.synchronize()
    held_off = torch.cuda.memory_allocated()
    assert held_off == held_on, (held_off, held_on)
    assert solvers.graph_replays == rep and n_off == n_on
    assert torch.equal(s.density(), den_on) and s.energy() == E_on


def _mg_f64_system(device):
    """hcp Mg (2 ions) at the benchmark's Mg f64 configuration: 23.151
    A^3/atom, c/a 1.630, WT-exp + PBE with ion-ion and the exact structure
    factor, float64, on ``ecut2shape``'s grid at 2000 eV."""
    from professad_tpu_torch import System
    from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                            WangTeterStyleFunctional,
                                            PerdewBurkeErnzerhof)
    ca = 1.630
    a = (2.0 * 23.151 / (np.sqrt(3.0) / 2.0 * ca)) ** (1.0 / 3.0)
    box = np.array([[a, 0.0, 0.0], [-a / 2, a * np.sqrt(3.0) / 2, 0.0],
                    [0.0, 0.0, ca * a]])
    frac = np.array([[1 / 3, 2 / 3, 0.25], [2 / 3, 1 / 3, 0.75]])
    wt = WangTeterStyleFunctional((5.0 / 6.0, 5.0 / 6.0, torch.exp))
    return System(box, System.ecut2shape(2000.0, box), [["Mg", MG_POT, frac]],
                  [IonIon, IonElectron, Hartree, wt.to(device).forward,
                   PerdewBurkeErnzerhof], units="a", coord_type="fractional",
                  device=device, dtype=torch.float64)


@pytest.mark.cuda
def test_precond_cache_gs_cold_solves(cuda):
    """Three gs-cold solves (ions displaced 0.10 A, from uniform; the
    benchmark's Mg f64 solver) on one System on the card: one build of
    M(k) and two hits, M never written, every iteration after the first a
    graph replay, and densities, energies and iteration counts bitwise
    those of the same solves with M rebuilt before each."""
    from professad_tpu_torch import system as tsys
    from professad_tpu_torch.ops import solvers
    kw = dict(ntol=2 * 2.5e-8, n_method="TPGD", analytic=True,
              precondition=True, jit_loop=True, n_step_size=1.0,
              skip_iters=2, n_conv_cond_count=3, from_uniform=True)
    s = _mg_f64_system(cuda)
    cart = (s.fractional_ionic_coordinates() @ s.lattice_vectors("a")).cpu()
    rng = np.random.default_rng(15)
    snaps = [cart.numpy() + 0.1 * rng.standard_normal(cart.shape)
             for _ in range(3)]

    def solves(clear):
        out, c0 = [], (tsys.precond_kernel_builds, tsys.precond_kernel_hits)
        for x in snaps:
            s.place_ions(x, coord_type="cartesian", units="a")
            if clear:
                s._precond_entry = None
            rep = solvers.graph_replays
            n_it, conv = s.optimize_density(**kw)
            assert conv and solvers.graph_replays - rep == n_it - 1 > 0
            out.append((s.density().clone(), s.energy(), n_it))
        torch.cuda.synchronize()
        return out, (tsys.precond_kernel_builds - c0[0],
                     tsys.precond_kernel_hits - c0[1])

    cached, counts = solves(False)
    assert counts == (1, 2)
    M = s._precond_entry[2]
    version = M._version
    rebuilt, counts = solves(True)
    assert counts == (3, 0) and M._version == version
    for (d0, e0, n0), (d1, e1, n1) in zip(cached, rebuilt):
        assert n0 == n1 and torch.equal(d0, d1) and e0 == e1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", FUNCTIONALS + ["WT+PBE", "main"])
def test_capturable_sweep_replays_bitwise(cuda, name, dtype):
    """Every term set ``capturable_terms`` admits: its bound sweep
    captured in a CUDA graph and replayed on a new density gives bitwise
    the eager sweep's energy and potential."""
    from professad_tpu_torch import models as tm
    from professad_tpu_torch.models import potentials as tpot
    from professad_tpu_torch.ops.solvers import _cuda_graph
    rng = np.random.default_rng(5)
    shape = (18, 18, 18)
    z = dict(dtype=dtype, device=cuda)
    box = torch.tensor(7.0 * np.eye(3) + 0.2 * rng.standard_normal((3, 3)),
                       **z)
    v_ext = torch.tensor(0.1 * rng.standard_normal(shape), **z)
    dens = [torch.tensor(0.01 + 0.02 * rng.random(shape), **z)
            for _ in range(2)]
    if name == "WT+PBE":
        terms = [tm.IonElectron, tm.Hartree, tm.WangTeter,
                 tm.PerdewBurkeErnzerhof]
    elif name == "main":
        terms = [tm.IonElectron, tm.Hartree,
                 tm.WangTeterStyleFunctional((5.0 / 6.0, 5.0 / 6.0,
                                              torch.exp)).to(cuda).forward,
                 tm.PerdewBurkeErnzerhof]
    else:
        term = _functionals()[name]
        terms = [term.to(cuda) if isinstance(term, torch.nn.Module)
                 else term]
    assert tpot.capturable_terms(terms)
    sweep = tpot.bind_sweep(terms)
    den = dens[0].clone()
    sweep(box, den, v_ext, N_elec=3.0)          # warm-up, as iteration 0
    out = {}

    def body():
        out["E"], out["pot"] = sweep(box, den, v_ext, N_elec=3.0)

    replay = _cuda_graph(body, cuda)
    for d in dens:
        den.copy_(d)
        replay()
        E_ref, p_ref = sweep(box, d, v_ext, N_elec=3.0)
        torch.cuda.synchronize()
        assert torch.equal(out["E"], E_ref) and torch.equal(out["pot"], p_ref)
