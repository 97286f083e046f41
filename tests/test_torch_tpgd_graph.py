"""The CUDA graph of the TPGD iteration (``ops/solvers.py``
``_IterationGraph``) and the bound analytic sweep
(``models/potentials.py`` ``bind_sweep``), on the CPU.

A CPU has no CUDA graph, so ``tpgd_minimize`` runs every iteration eagerly
there, as it does with a ``stop_fn`` or the autograd gradient: the replay
counter stays where it was.  The graph's iteration body is checked here by
standing in a plain call for the capture (``_cuda_graph``), which runs the
body on the state's own tensors at each "replay": its iterates, counts and
best-iterate choice are bitwise those of the eager loop.  The capture
itself runs on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from professad_tpu_torch import System
from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                        WangTeterStyleFunctional,
                                        PerdewBurkeErnzerhof)
from professad_tpu_torch.models import potentials as tpot
from professad_tpu_torch.ops import solvers
from professad_tpu_torch.ops.grid import safe_sqrt
from paths import pot

FRAC = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5],
                 [0.0, 0.48, 0.53]])
EV_PER_HA = 27.211386245988


def _wt_exp():
    return WangTeterStyleFunctional((5.0 / 6.0, 5.0 / 6.0, torch.exp))


def _system(dtype=torch.float64, shape=(12, 12, 12)):
    """4-atom fcc Al, one ion displaced, WT-exp + PBE."""
    return System(4.05 * np.eye(3), shape, [["Al", pot("al.gga.recpot"),
                                             FRAC]],
                  [IonIon, IonElectron, Hartree, _wt_exp().forward,
                   PerdewBurkeErnzerhof], units="a",
                  coord_type="fractional", device="cpu", dtype=dtype)


def _counts():
    return solvers.graph_replays, solvers.eager_iterations


def _solve(s, capturable, stag_k=6, track_best=True, ntol=1e-9):
    """tpgd_minimize on the System's fused analytic path from the uniform
    start, as ``optimize_density(jit_loop=True, analytic=True)`` calls
    it."""
    dt = s._dtype
    box, v_ext, N = s._box_vecs.to(dt), s._v_ext.to(dt), float(s._N_elec)
    vg, _ = s._analytic_solve_fn(box, v_ext, N, None, "TPGD")
    M = s._apply_spectral(s._cell_precond_kernel(dt))
    return solvers.tpgd_minimize(
        vg, safe_sqrt(s._uniform_density()).to(dt), lr=1.0,
        ntol=ntol, conv_count=3, max_iter=300, f_scale=EV_PER_HA,
        skip_iters=2, apply_H0=M, stag_k=stag_k, track_best=track_best,
        capturable=capturable)


@pytest.fixture
def graph_on_cpu(monkeypatch):
    """The graph path on CPU tensors: the engagement rule without its
    CUDA condition, and a plain call of the body in place of each
    replay."""
    monkeypatch.setattr(solvers, "_graph_engages",
                        lambda capturable, x0, group, stop_fn:
                        capturable and group is None and stop_fn is None)
    monkeypatch.setattr(solvers, "_cuda_graph", lambda fn, device: fn)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("stag_k,track_best", [(6, True), (2, True),
                                               (2, False)])
def test_graph_iterations_are_bitwise_the_eager_ones(graph_on_cpu, dtype,
                                                     stag_k, track_best):
    """The in-place iteration body, run at every replay, gives bitwise
    the eager loop's end point, energy, iteration count and convergence,
    with the same best-iterate choice and stagnation damping (``stag_k``
    2 makes the damping fire); one eager iteration, the rest replays."""
    s = _system(dtype)
    st_e, it_e, conv_e = _solve(s, False, stag_k, track_best)
    r0, e0 = _counts()
    st_g, it_g, conv_g = _solve(s, True, stag_k, track_best)
    r1, e1 = _counts()
    assert (it_g, conv_g) == (it_e, conv_e) and it_e > 3
    assert (r1 - r0, e1 - e0) == (it_g - 1, 1)
    assert torch.equal(st_g.x, st_e.x) and torch.equal(st_g.f, st_e.f)
    assert torch.equal(st_g.g, st_e.g)


def test_graph_keeps_a_best_iterate_the_replays_do_not_overwrite(
        graph_on_cpu):
    """Where the best iterate is not the last one, the returned x is the
    best-iterate buffer, equal to the eager loop's best iterate, and not
    the state the replays overwrite."""
    s = _system(torch.float32)
    st_e, _, _ = _solve(s, False, 2, True, ntol=1e-12)
    st_g, it, _ = _solve(s, True, 2, True, ntol=1e-12)
    assert torch.equal(st_g.x, st_e.x) and torch.equal(st_g.f, st_e.f)
    assert it > 3


@pytest.mark.parametrize("case", ["cpu", "stop_fn", "autograd"])
def test_eager_where_the_graph_cannot_engage(case):
    """CPU tensors, a ``stop_fn`` (conv_target other than 'dE') or the
    autograd gradient: every iteration runs eagerly, no replay, and the
    result is that of the same solve told its sweep is not capturable."""
    s = _system()
    kw = dict(ntol=1e-9, n_method="TPGD", n_step_size=1.0, skip_iters=2,
              jit_loop=True, precondition=True, from_uniform=True,
              analytic=case != "autograd")
    if case == "stop_fn":
        kw.update(conv_target="dEdchi", ntol=1e-4)
    r0, e0 = _counts()
    n_it, conv = s.optimize_density(**kw)
    r1, e1 = _counts()
    assert conv and (r1 - r0, e1 - e0) == (0, n_it)
    den = s.density()
    off = _system()
    if case == "cpu":
        st, it, _ = _solve(off, False)
        st_on, it_on, _ = _solve(off, True)
        assert it_on == it and torch.equal(st_on.x, st.x)
        assert torch.equal(st_on.f, st.f)
    else:
        off.optimize_density(**kw)
        assert torch.equal(off.density(), den)


def test_engagement_rule():
    """The graph engages only for a capturable sweep on CUDA tensors with
    no group and no stop_fn."""
    class Cuda:
        is_cuda = True
    cuda, cpu = Cuda(), torch.zeros(1)
    assert solvers._graph_engages(True, cuda, None, None)
    assert not solvers._graph_engages(False, cuda, None, None)
    assert not solvers._graph_engages(True, cpu, None, None)
    assert not solvers._graph_engages(True, cuda, object(), None)
    assert not solvers._graph_engages(True, cuda, None, lambda st, f: f)


def test_capturable_terms():
    """The main path's terms are capturable; a term that reads host
    scalars in every evaluation keeps the solve eager."""
    from professad_tpu_torch import models as tm
    import functools
    main = [IonIon, IonElectron, Hartree, _wt_exp().forward,
            PerdewBurkeErnzerhof]
    assert tpot.capturable_terms(main)
    assert tpot.capturable_terms([tm.WangTeter, tm.PerdewZunger,
                                  tm.PauliGaussian()])
    assert not tpot.capturable_terms(main + [tm.WangGovindCarter99()])
    assert not tpot.capturable_terms([functools.partial(tm.KGAP,
                                                        E_gap=1.0)])
    assert not tpot.capturable_terms([tm.XuWangMa])


def _wtsf_case(dtype):
    rng = np.random.default_rng(11)
    shape = (12, 10, 14)
    box = torch.tensor(6.5 * np.eye(3) + 0.2 * rng.standard_normal((3, 3)),
                       dtype=dtype)
    dens = [torch.tensor(0.01 + 0.02 * rng.random(shape), dtype=dtype)
            for _ in range(3)]
    return box, dens, torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_wtsf_parameters_read_once_per_binding(monkeypatch, dtype):
    """``_vp_wtsf`` with its exponents read once per binding gives bitwise
    the energy and potential of a read in every evaluation, and reads the
    parameters once however many evaluations follow."""
    f = WangTeterStyleFunctional((0.8, 0.7, torch.exp))
    box, dens, v0 = _wtsf_case(dtype)
    each = [tpot.value_and_potential([f.forward], box, d, v0) for d in dens]
    reads = []
    detached = tpot._detached
    monkeypatch.setattr(tpot, "_detached",
                        lambda owner: reads.append(1) or detached(owner))
    sweep = tpot.bind_sweep([f.forward])
    once = [sweep(box, d, v0) for d in dens]
    assert len(reads) == 1
    for (E1, p1), (E2, p2) in zip(once, each):
        assert torch.equal(E1, E2) and torch.equal(p1, p2)
        assert E1.dtype == torch.float64 and p1.dtype == dtype


def test_a_new_binding_reads_changed_parameters():
    """A trainable functional's parameters are read per binding, not once
    for ever: after a change, a new binding gives the new energy."""
    f = WangTeterStyleFunctional((0.8, 0.7, torch.exp))
    box, dens, v0 = _wtsf_case(torch.float64)
    old = tpot.bind_sweep([f.forward])
    E_old, _ = old(box, dens[0], v0)
    with torch.no_grad():
        f.params["alpha"].fill_(0.75)
    E_new, p_new = tpot.bind_sweep([f.forward])(box, dens[0], v0)
    E_ref, p_ref = tpot.value_and_potential([f.forward], box, dens[0], v0)
    assert torch.equal(E_new, E_ref) and torch.equal(p_new, p_ref)
    assert not torch.equal(E_new, E_old)
    assert torch.equal(old(box, dens[0], v0)[0], E_old)
