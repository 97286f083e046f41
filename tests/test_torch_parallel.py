"""Whole distributed density optimizations of the port on gloo ranks
(P = 2 and 4): ``System.optimize_density(mesh=...)`` (TPGD and L-BFGS, the
fused analytic and the autograd gradient, with and without the
preconditioner, f64 and f32) and ``pfft.pencil_tpgd_minimize`` with the
hand-fused WT + PBE gradient, against the port's serial path and the JAX
package's serial path, and every argument the mesh path rejects.

Li2 with one ion displaced (16^3, WT + PBE), as the JAX package's parallel
tests.  The JAX serial path is the JAX package's whole-optimization TPGD
(``ops.solvers.tpgd_minimize``, jitted) on the JAX terms' chi energy, fed
the port's v_ext and preconditioner kernel (each equal to the JAX
package's at 1e-12 in the single-device tests): a JAX ``System``'s eager
set-up compiles some 150 small programs, this path one.  Bounds of
``tests/test_parallel.py:103``: the energy within 1e-10 relative, the
density within 1e-6 (the solves stop on |dE|, so their landing points
differ by the rule's scatter).  One group per rank count
runs every case (``torch_parallel_cases.solve_cases``) while the parent
computes the references.
"""

import threading
import time

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from professad_tpu.ops import solvers as jsolvers
from professad_tpu.models import (IonElectron as jIonElectron,
                                  Hartree as jHartree,
                                  WangTeter as jWangTeter,
                                  PerdewBurkeErnzerhof as jPBE)

import torch_parallel_cases as C
import torch_ranks
from torch_ranks import start_ranks

RANKS = (2, 4)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    return {p: start_ranks(C.solve_cases, p, tmp_path_factory.mktemp(f"p{p}"))
            for p in RANKS}


@pytest.fixture(scope="module")
def ref(groups):
    """The serial references, computed while the groups run: the port's
    serial runs of every case, and the JAX package's serial TPGD."""
    out = {}
    for name in C.SOLVE_RUNS:
        s, n_it, conv = C.run_solve(name)
        out[name] = dict(E=s.energy(), n_it=n_it, conv=conv,
                         den=s.density().numpy())
    for method, shape in C.FUSED_SHAPE.items():
        s = C.li2(shape)
        s.optimize_density(**C.SOLVE)
        out[f"fused_{method}"] = dict(
            E=float(s._compute_energy(for_den_opt=True)),
            den=s.density().numpy(), N=s._N_elec, vol=s.volume("b3"))
    out["jax"] = _jax_ground_state()
    return out


def _jax_ground_state():
    s = C.li2()
    N, vol = float(s._N_elec), s.volume("b3")
    box = jnp.asarray(s._box_vecs.numpy())
    v = jnp.asarray(s._v_ext.numpy())
    M = jnp.asarray(s._exact_precond_kernel(s._box_vecs, N).numpy())
    terms = [jIonElectron, jHartree, jWangTeter, jPBE]

    def chi_energy(chi):
        den = N * chi * chi / (jnp.mean(chi * chi) * vol)
        return sum(t(box, den, v) if t is jIonElectron else t(box, den)
                   for t in terms)

    def solve(chi0):
        return jsolvers.tpgd_minimize(
            jax.value_and_grad(chi_energy), chi0, lr=1.0, ntol=1e-9,
            conv_count=3, max_iter=1000, f_scale=27.211386245988,
            skip_iters=2, apply_H0=lambda q: jnp.fft.irfftn(
                M * jnp.fft.rfftn(q), C.FIELD_SHAPE))

    st, _, conv = jax.jit(solve)(jnp.sqrt(jnp.asarray(s._den.numpy())))
    assert bool(conv)
    chi = np.asarray(st.x)
    E = float(st.f) + float(s._ion_ion_energy())
    return dict(E=E, den=N * chi * chi / (np.mean(chi * chi) * vol))


@pytest.mark.parametrize("p", RANKS)
@pytest.mark.parametrize("name", [n for n in C.SOLVE_RUNS if n != "f32"])
def test_mesh_optimize_density_matches_serial(groups, ref, p, name):
    got, want = groups[p].result()[name], ref[name]
    assert got["conv"] and want["conv"]
    if name == "plain":   # the plain BB steps take more iterations
        assert want["n_it"] > ref["tpgd"]["n_it"]
    assert got["attached"], "optimize_density(mesh=) attaches the mesh"
    assert abs(got["E"] - want["E"]) <= 1e-10 * abs(want["E"])
    assert np.max(np.abs(got["den"] - want["den"])) < 1e-6
    if name != "lbfgs":   # the mesh path's L-BFGS checks every iteration
        assert got["n_it"] == want["n_it"]


@pytest.mark.parametrize("p", RANKS)
@pytest.mark.parametrize("name", ["tpgd", "lbfgs"])
def test_mesh_optimize_density_matches_jax(groups, ref, p, name):
    got, want = groups[p].result()[name], ref["jax"]
    assert abs(got["E"] - want["E"]) <= 1e-10 * abs(want["E"])
    assert np.max(np.abs(got["den"] - want["den"])) < 1e-6


@pytest.mark.parametrize("p", RANKS)
def test_mesh_f32_tier(groups, ref, p):
    """The f32 mesh solve lands within the f32 bound of
    tests/test_f32_accuracy.py (2e-5 eV/atom) of the serial f32 solve."""
    got = groups[p].result()["f32"]
    assert got["conv"]
    assert abs(got["E"] - ref["f32"]["E"]) * 27.211386245988 / 2 < 2e-5


@pytest.mark.parametrize("p", RANKS)
@pytest.mark.parametrize("method", ["TPGD", "LBFGS"])
def test_pencil_tpgd_minimize_hand_fused(groups, ref, p, method):
    """The hand-fused WT + PBE distributed gradient through the SPMD
    solver reaches the serial ground state (density terms only: the
    ion-ion energy is the System's)."""
    got, want = groups[p].result()[f"fused_{method}"], ref[f"fused_{method}"]
    assert got["conv"]
    assert abs(got["f"] - want["E"]) <= 1e-10 * abs(want["E"])
    chi = got["chi"].reshape(want["den"].shape)
    den = chi * chi * want["N"] / (np.mean(chi * chi) * want["vol"])
    assert np.max(np.abs(den - want["den"])) < 1e-6


REJECTIONS = {
    "jit_loop": "jit_loop=True",
    "conv_target": "conv_target",
    "potentials": "potentials",
    "analytic": "analytic",
    "indivisible": "divisible",
    "set_mesh_shape": "must divide",
    "eos_batched_grid": "batched=False",
}


@pytest.mark.parametrize("p", RANKS)
@pytest.mark.parametrize("case", list(REJECTIONS))
def test_mesh_rejections(groups, p, case):
    """Every argument without a distributed form raises ValueError, as in
    tests/test_parallel.py:416 and tests/test_parallel_generic.py:591-620."""
    err = groups[p].result()["errors"][case]
    assert err is not None and err.startswith("ValueError"), err
    assert REJECTIONS[case] in err, err


def test_ranks_past_deadline_are_terminated(tmp_path, monkeypatch):
    """``result()`` raises at its deadline, naming the ranks still alive,
    leaves none of them running, and raises the same error when asked
    again."""
    deadline = 8
    monkeypatch.setattr(torch_ranks, "RANK_DEADLINE_S", deadline)
    t0 = time.monotonic()
    g = start_ranks(C.sleep_cases, 2, tmp_path)
    caught = []
    waiter = threading.Thread(target=lambda: caught.append(
        pytest.raises(TimeoutError, g.result).value), daemon=True)
    waiter.start()
    waiter.join(deadline + 60)
    waited = time.monotonic() - t0
    assert not waiter.is_alive(), "result() did not return"
    assert caught and "ranks [0, 1] of 2" in str(caught[0]), caught
    assert waited < deadline + 15, waited
    assert not any(p.is_alive() for p in g._ctx.processes)
    with pytest.raises(TimeoutError) as again:
        g.result()
    assert again.value is caught[0]
