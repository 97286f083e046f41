"""The multi-device cases of the port's parallel tests, run on every gloo
rank by ``torch_ranks.start_ranks`` (this module imports no JAX), and the
set-ups the tests' serial references share with them.

Each ``*_cases(mesh)`` function runs a test file's whole set of cases in
one process group and returns plain numpy values: whole fields gathered
from the ranks, energies, errors raised (as their messages)."""

import os
import sys
import time

import numpy as np
import torch

from professad_tpu_torch import System
from professad_tpu_torch.models import (
    IonIon, IonElectron, Hartree, ThomasFermi, Weizsaecker, PerdewWang,
    PerdewZunger, Chachiyo, vWGTF1, PerdewBurkeErnzerhof, WangTeter,
    WangGovindCarter99, FoleyMadden, XuWangMa, HuangCarter, lda_exchange)
from professad_tpu_torch.parallel import (
    grid_group, grid_sharding, gather_grid, pfft, rank_share, psum,
    all_gather)
from professad_tpu_torch.ops import grid as ogrid
from professad_tpu_torch.ops import fieldconv
from professad_tpu_torch.models import ions

POT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "potentials")
F64 = torch.float64
FFT_SHAPE = (8, 12, 10)
FIELD_SHAPE = (16, 16, 16)
TERM_SHAPE = (8, 8, 8)
LI_LEN = 6.96
LI_FRAC = np.array([[0.02, 0.05, 0.0], [0.5, 0.5, 0.47]])
WT_PBE = [IonIon, IonElectron, Hartree, WangTeter, PerdewBurkeErnzerhof]
LOCAL = [IonIon, IonElectron, Hartree, ThomasFermi, Weizsaecker, PerdewWang]
SOLVE = dict(ntol=1e-9, jit_loop=True, precondition=True, n_step_size=1.0,
             n_method="TPGD", skip_iters=2, analytic=True)


def term_sets():
    """The term sets of the JAX package's generic pencil tests (fresh
    instances per call: the instance terms carry state)."""
    return [
        ("TF_vW_PW92", [IonElectron, Hartree, ThomasFermi, Weizsaecker,
                        PerdewWang]),
        ("vWGTF1_PBE", [IonElectron, Hartree, vWGTF1,
                        PerdewBurkeErnzerhof]),
        ("WGC99_PZ81", [IonElectron, Hartree, WangGovindCarter99(),
                        PerdewZunger]),
        ("FM_Chachiyo", [IonElectron, Hartree, FoleyMadden(), Chachiyo]),
        ("XWM_LDA", [IonElectron, Hartree, XuWangMa, lda_exchange]),
        ("WT_PBE", [IonElectron, Hartree, WangTeter, PerdewBurkeErnzerhof]),
    ]


def fields(shape=TERM_SHAPE, seed=0):
    """A smooth positive density and a random external potential (the JAX
    package's ``_fields``), float64 numpy."""
    rng = np.random.default_rng(seed)
    spec = np.zeros(shape, dtype=complex)
    spec[:3, :3, :3] = (rng.normal(size=(3, 3, 3))
                        + 1j * rng.normal(size=(3, 3, 3)))
    bumps = np.real(np.fft.ifftn(spec))
    den = 0.03 * (1.0 + 0.4 * bumps / np.max(np.abs(bumps)))
    return den, 0.1 * rng.standard_normal(shape)


def fft_field(dtype=F64, seed=1):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal(FFT_SHAPE), dtype=dtype)


def box():
    return torch.tensor([[7.0, 0.3, 0.0], [0.0, 7.5, 0.2], [0.1, 0.0, 8.0]],
                        dtype=F64)


def li2(shape=FIELD_SHAPE, terms=None, pme_order=None, dtype=F64):
    """Li2 with one ion off its symmetric site (nonzero forces and an
    anisotropic stress), the JAX package's ``_li2_system``."""
    return System(LI_LEN * np.eye(3), shape,
                  [["Li", os.path.join(POT, "li.gga.recpot"),
                    LI_LEN * LI_FRAC]],
                  list(WT_PBE if terms is None else terms), units="b",
                  pme_order=pme_order, device="cpu", dtype=dtype)


def hc_term():
    return HuangCarter((0.01177, 0.7143, 1.2))


def _slab(x, mesh):
    return grid_sharding(mesh)(x)


def _kgather(X, mesh):
    """The whole spectrum from the ranks' axis-1 k-pencils."""
    return all_gather(X, 1, grid_group(mesh)[0])


def _err(fn):
    try:
        fn()
    except Exception as e:     # the message is what the tests read
        return f"{type(e).__name__}: {e}"
    return None


def _np(t):
    return t.detach().cpu().numpy()


# --------------------------- tests/test_torch_pfft.py ----------------------

def pfft_cases(mesh):
    group, P, _ = grid_group(mesh)
    out = {}
    x = fft_field()
    xl = _slab(x, mesh)
    X = pfft.prfftn(xl, group)
    out["prfftn"] = _np(_kgather(X, mesh))
    out["pirfftn"] = _np(gather_grid(pfft.pirfftn(X, xl.shape, group), mesh))
    out["prfftn_dc64"] = _np(_kgather(pfft.prfftn_dc(xl, group), mesh))
    kx, ky, kz, k2 = pfft.pwavevecs(box(), FFT_SHAPE, group)
    out["pwavevecs"] = [_np(_kgather(k, mesh)) for k in (kx, ky, kz, k2)]
    out["pmean"] = float(pfft.pmean(xl, group))
    out["pqmean"] = float(pfft.pqmean(xl, group))
    out["pwmean"] = float(pfft.pwmean(xl, group))
    x32 = (1.5 + fft_field()).to(torch.float32)
    xl32 = _slab(x32, mesh)
    X32 = pfft.prfftn_dc(xl32, group)
    out["prfftn_dc32"] = _np(_kgather(X32, mesh))
    out["pirfftn_dc32"] = _np(gather_grid(
        pfft.pirfftn_dc(X32, xl32.shape, group), mesh))
    out["pqmean32"] = float(pfft.pqmean(xl32, group))
    out["pwmean32"] = float(pfft.pwmean(xl32, group))
    out["pqmean32_dtype"] = str(pfft.pqmean(xl32, group).dtype)
    out["pwmean32_dtype"] = str(pfft.pwmean(xl32, group).dtype)

    # per-slab uniform f32 stacks round-trip exactly (the ladder's DC split)
    vals = np.asarray([0.031415927, 1.25, 0.0007], np.float32)
    u = torch.tensor(vals).expand(8, 8, 8, 3).clone()
    ul = _slab(u, mesh)
    rt = pfft.pirfftn_dc(pfft.prfftn_dc(ul, group), ul.shape, group)
    out["dc_vals"] = vals
    out["dc_roundtrip"] = _np(gather_grid(rt, mesh))
    rt3 = pfft.pirfftn_dc(pfft.prfftn_dc(ul[..., 1].contiguous(), group),
                          ul.shape[:3], group)
    out["dc_roundtrip3"] = _np(gather_grid(rt3, mesh))

    # the x P trap: the replicated sum differentiated on every rank
    w = torch.tensor(np.arange(1.0, 1.0 + xl.numel()).reshape(xl.shape),
                     dtype=F64)
    with torch.enable_grad():
        a = xl.clone().requires_grad_(True)
        S = psum(torch.sum(w * a), group)
        (g_all,) = torch.autograd.grad(S, a)
        a = xl.clone().requires_grad_(True)
        S = psum(torch.sum(w * a), group)
        (g_share,) = torch.autograd.grad(rank_share(S, group), a)
    out["trap_all"] = _np(g_all / w)
    out["trap_share"] = _np(g_share / w)

    # energies, density gradients, cell gradients and the fused sweeps of
    # every term set on this rank's slabs
    den_np, v_np = fields()
    den, v = torch.tensor(den_np), torch.tensor(v_np)
    dl, vl = _slab(den, mesh), _slab(v, mesh)
    h0 = box()
    for name, terms in term_sets():
        with torch.enable_grad():
            d = dl.clone().requires_grad_(True)
            h = h0.clone().requires_grad_(True)
            E = pfft.penergy_terms(terms, h, d, vl, group)
            gd, gh = torch.autograd.grad(rank_share(E, group), (d, h))
        out[f"E_{name}"] = float(E.detach())
        out[f"dEdn_{name}"] = _np(gather_grid(gd, mesh))
        out[f"dEdh_{name}"] = _np(psum(gh, group))
        chi = torch.sqrt(dl).reshape(-1)
        N = float(np.mean(den_np) * float(torch.abs(torch.det(h0))))
        Ea, ga = pfft.pchi_value_and_grad_analytic(
            terms, chi, h0, vl, N, TERM_SHAPE, group)
        Et, gt = pfft.pchi_value_and_grad_terms(
            terms, chi, h0, vl, N, TERM_SHAPE, group)
        out[f"chiE_{name}"] = (float(Ea), float(Et))
        out[f"chig_{name}"] = (_np(gather_grid(ga.reshape(dl.shape), mesh)),
                               _np(gather_grid(gt.reshape(dl.shape), mesh)))
    chi = torch.sqrt(dl).reshape(-1)
    N = float(np.mean(den_np) * float(torch.abs(torch.det(h0))))
    Ew, gw = pfft.pchi_value_and_grad(chi, h0, vl, N, TERM_SHAPE, group)
    out["wt_pbe_fused"] = (float(Ew),
                           _np(gather_grid(gw.reshape(dl.shape), mesh)))
    out["penergy_wt_pbe"] = float(pfft.penergy_wt_pbe(h0, dl, vl,
                                                      TERM_SHAPE, group))

    # spectral_convolution under pencil_mode composes the pencil
    # transforms and never calls the spectral_conv kernel wrapper
    from professad_tpu_torch.ops import spectral_conv as sc
    calls = []
    real = sc.spectral_conv

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    sc.spectral_conv = counted
    try:
        with ogrid.pencil_mode(mesh):
            _, _, _, k2p = ogrid.wavevecs(h0, dl.shape)
            conv = ogrid.spectral_convolution(-k2p, dl, dl.shape)
    finally:
        sc.spectral_conv = real
    out["conv_calls"] = len(calls)
    out["conv"] = _np(gather_grid(conv, mesh))

    # a prepared ladder term: the field-dependent convolution's ladder
    # axis rides one all_to_all; an unprepared one raises
    hc = hc_term()
    hc.prepare(h0, den)
    E_hc = pfft.penergy_terms([hc], h0, dl, vl, group)
    aux = pfft.aux_pencil_specs([hc.aux_arrays()], group)
    E_hc_aux = pfft.penergy_terms([hc], h0, dl, vl, group, aux=aux)
    out["E_hc"] = (float(E_hc), float(E_hc_aux))
    with ogrid.pencil_mode(group):
        W = pfft.aux_pencil_specs([hc.aux_arrays()], group)[0]["slabs"]
        lc = fieldconv.ladder_convolution(W, dl, dl.shape)
    out["ladder_conv"] = _np(gather_grid(lc, mesh))
    out["hc_unprepared"] = _err(
        lambda: pfft.penergy_terms([hc_term()], h0, dl, vl, group))
    out["naive_raises"] = _err(lambda: _naive_under_pencil(mesh, dl))

    # the PME structure factor from the slab spread
    cart = torch.tensor([[0.3, 0.2, 0.1], [3.6, 3.9, 3.3], [1.0, 6.5, 7.7]],
                        dtype=F64)
    with ogrid.pencil_mode(group):
        S = ions.structure_factor_spline(h0, dl.shape, cart, 8)
        latt = ions.lattice_sum(h0, dl.shape, cart,
                                torch.ones_like(S.real), 8)
    out["pme_S"] = _np(_kgather(S, mesh))
    out["pme_latt"] = _np(gather_grid(latt, mesh))
    out["jax_modules"] = sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "professad_tpu"))
    return out


def _naive_under_pencil(mesh, dl):
    with ogrid.pencil_mode(mesh):
        fieldconv.field_dependent_convolution_naive(
            dl, lambda k, xi: k, dl, dl)


# ------------------------- tests/test_torch_parallel.py --------------------

SOLVE_RUNS = {
    "tpgd": (FIELD_SHAPE, SOLVE),
    "lbfgs": (FIELD_SHAPE, dict(SOLVE, n_method="LBFGS")),
    "autodiff": ((8, 8, 8), dict(SOLVE, analytic=False)),
    # no preconditioner: plain BB steps, the local terms to keep them few
    "plain": ((8, 8, 8), dict(SOLVE, precondition=False, n_step_size=0.05,
                              ntol=1e-7, n_maxiter=4000)),
    "f32": ((8, 8, 8), dict(SOLVE, ntol=1e-7)),
}
SOLVE_TERMS = {"plain": LOCAL}
SOLVE_DTYPE = {"f32": torch.float32}
FUSED_SHAPE = {"TPGD": FIELD_SHAPE, "LBFGS": (8, 8, 8)}


def run_solve(name, mesh=None):
    """One case of ``SOLVE_RUNS``, serially or on ``mesh``: (System,
    steps, converged).  The autograd run starts from the analytic ground
    state (the fewer iterations of the slow path, the same minimum)."""
    shape, kw = SOLVE_RUNS[name]
    s = li2(shape, terms=SOLVE_TERMS.get(name),
            dtype=SOLVE_DTYPE.get(name, F64))
    if name == "autodiff":
        s.optimize_density(**dict(kw, analytic=True, ntol=1e-6))
    n_it, conv = s.optimize_density(mesh=mesh, **kw)
    return s, n_it, conv


def solve_cases(mesh):
    out = {}
    for name in SOLVE_RUNS:
        s, n_it, conv = run_solve(name, mesh)
        out[name] = dict(E=s.energy(), n_it=n_it, conv=conv,
                         den=_np(s.density()), attached=s._mesh is mesh)

    # the hand-fused WT + PBE gradient through pencil_tpgd_minimize, TPGD
    # and L-BFGS
    for method, shape in FUSED_SHAPE.items():
        s = li2(shape)
        st, n_it, conv = pfft.pencil_tpgd_minimize(
            mesh, shape, s._box_vecs, s._v_ext, float(s._N_elec),
            torch.sqrt(s._den).reshape(-1),
            s._exact_precond_kernel(s._box_vecs, float(s._N_elec)),
            lr=1.0, ntol=1e-9, max_iter=500, method=method)
        out[f"fused_{method}"] = dict(
            f=float(st.f), n_it=n_it, conv=conv,
            chi=_np(gather_grid(st.x.reshape(-1), mesh)))

    # every rejection of the JAX package's mesh tests
    s = li2((8, 8, 8))
    err = {
        "jit_loop": lambda: s.optimize_density(mesh=mesh, jit_loop=False),
        "conv_target": lambda: s.optimize_density(
            mesh=mesh, jit_loop=True, n_method="TPGD", conv_target="euler"),
        "potentials": lambda: s.optimize_density(
            mesh=mesh, jit_loop=True, n_method="TPGD",
            potentials=lambda b, d: torch.zeros_like(d)),
        "analytic": lambda: li2((8, 8, 8), terms=[
            IonElectron, Hartree, lambda b, d: ThomasFermi(b, d)]
        ).optimize_density(mesh=mesh, jit_loop=True, n_method="TPGD",
                           analytic=True),
        "indivisible": lambda: pfft.pencil_tpgd_minimize(
            mesh, (9, 16, 16), torch.eye(3, dtype=F64),
            torch.zeros((9, 16, 16), dtype=F64), 4.0,
            torch.ones(9 * 16 * 16, dtype=F64),
            torch.ones((9, 16, 9), dtype=F64)),
        "set_mesh_shape": lambda: li2((9, 16, 16)).set_mesh(mesh),
        "eos_batched_grid": lambda: li2((8, 8, 8)).eos_fit(
            mesh=mesh, batched=True),
    }
    out["errors"] = {k: _err(fn) for k, fn in err.items()}
    return out


# -------------------- tests/test_torch_parallel_properties.py --------------

def geometry(p):
    """The parameterized cubic Li2 cell of the JAX package's test: (box,
    frac)."""
    bx = p[0] * torch.eye(3, dtype=F64)
    return bx, torch.tensor(LI_FRAC, dtype=F64)


GEOM_STEP = dict(ftol=None, stol=1e-5, g_maxiter=1, g_method="TPGD",
                 g_step_size=0.05, **dict(SOLVE))


def property_cases(mesh):
    out = {}
    s = li2()
    s.optimize_density(mesh=mesh, **SOLVE)
    den = s.density()
    out["den"] = _np(den)
    out["F"] = _np(s.forces())
    out["sigma"] = _np(s.stress())
    out["E_assembly"] = float(s._compute_energy())
    # the derivatives are held at any density: reuse this one
    s = li2(terms=GENERIC)
    s.set_density(den)
    s.set_mesh(mesh)
    out["generic_sigma"] = _np(s.stress())
    s = li2(pme_order=8)
    s.set_density(den)
    s.set_mesh(mesh)
    out["pme_F"] = _np(s.forces())
    out["pme_sigma"] = _np(s.stress())

    # the HC kernel hoists threaded through the mesh energy
    s = hc_system()
    s.set_mesh(mesh)
    out["hc_E"] = float(s._compute_energy())

    # one geometry relaxation through the mesh
    s = li2(RELAX_SHAPE, terms=LOCAL)
    ok = s.optimize_geometry(mesh=mesh, **RELAX)
    out["relax"] = dict(ok=ok, F=_np(s.forces("eV/a")),
                        frac=_np(s.fractional_ionic_coordinates()),
                        den=_np(s.density()), attached=s._mesh is mesh)
    # one fixed TPGD step of the parameterized geometry
    s = li2(RELAX_SHAPE)
    s.set_mesh(mesh)
    _, p = s.optimize_parameterized_geometry(
        torch.tensor([LI_LEN], dtype=F64), geometry, **GEOM_STEP)
    out["param_p"] = _np(p)
    return out


GENERIC = [IonIon, IonElectron, Hartree, vWGTF1, PerdewBurkeErnzerhof]
RELAX_SHAPE = (8, 8, 8)
RELAX = dict(ftol=0.02, stol=None, g_maxiter=60, **dict(SOLVE, ntol=1e-8))


def hc_system():
    s = System(4.05 * np.array([[0.5, 0.5, 0.0], [0.0, 0.5, 0.5],
                                [0.5, 0.0, 0.5]]), FIELD_SHAPE,
               [["Al", os.path.join(POT, "al.gga.recpot"), np.zeros((1, 3))]],
               [IonIon, IonElectron, Hartree, hc_term(),
                PerdewBurkeErnzerhof], units="a", coord_type="fractional",
               device="cpu")
    s._terms[3].prepare(s._box_vecs, s._den)
    return s


# --------------------- tests/test_torch_parallel_implicit.py ---------------

IMPLICIT_SHAPE = (8, 8, 8)
EOS = dict(f=0.05, N=5, ntol=1e-9, n_method="TPGD", n_step_size=1.0,
           skip_iters=2, jit_loop=True, analytic=True)
FCC = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5],
                [0.0, 0.5, 0.5]])


def fcc_al(shape=IMPLICIT_SHAPE):
    """4-atom cubic fcc Al with WT + PBE, the benchmark configuration,
    whose EOS minimum lies inside +-5% of its cell at 8^3."""
    return System(4.05 * np.eye(3), shape,
                  [["Al", os.path.join(POT, "al.gga.recpot"), FCC]],
                  list(WT_PBE), units="a", coord_type="fractional",
                  device="cpu")


def implicit_state(terms=LOCAL):
    s = li2(IMPLICIT_SHAPE, terms=terms)
    s.optimize_density(**dict(SOLVE, ntol=1e-11))
    return s


def implicit_cases(mesh):
    out = {}
    s = implicit_state()
    s.set_mesh(mesh)
    out["P"] = s.pressure()
    out["H"] = s.enthalpy()
    out["K"] = s.bulk_modulus()
    out["C"] = _np(s.elastic_constants())
    out["Phi"] = _np(s.force_constants([0]))
    s = implicit_state(WT_PBE)
    s.set_mesh(mesh)
    out["K_wt_pbe"] = s.bulk_modulus()

    # the EOS scan with each volume's solve on the pencils
    out["eos_grid"] = np.asarray(fcc_al().eos_fit(mesh=mesh, **EOS)[0])
    # the batched scan with its volumes split over the "batch" ranks
    from professad_tpu_torch.parallel import make_mesh
    bmesh = make_mesh(batch=grid_group(mesh)[1])
    out["eos_batch"] = np.asarray(fcc_al().eos_fit(mesh=bmesh, batched=True,
                                                   **EOS)[0])
    return out


def sleep_cases(mesh):
    """Outlasts any deadline a test gives its ranks."""
    time.sleep(600)
    return {}
