"""The port's Huang-Carter and revHC against the JAX package, f64 on the
CPU: the ODE kernel tables, the ladder and slabs of ``prepare``, the
energies and fused potentials, and the chi gradient with the term-aux
(their stress is held in ``test_torch_ladder_paths.py``).

Inputs come from numpy with a seed (the 14^3 random states of
``tests/test_potentials.py``) and go through both packages; the JAX
functional's ladder and tables are carried across with
``functional_state_from_jax``, so both evaluate the same ladder.  Parity
and fused-potential tolerances are rtol 1e-10; the kernel tables are held
at rtol 1e-13.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from professad_tpu import models as jm
from professad_tpu import system as jsys
from professad_tpu.models import potentials as jpot
from professad_tpu_torch import System, functional_state_from_jax
from professad_tpu_torch import models as tm
from professad_tpu_torch.models import potentials as tpot
from professad_tpu_torch.ops.autodiff import get_functional_derivative

RTOL = 1e-10
HC_ARGS = (0.45, 0.51, 1.2)
REVHC_ARGS = (0.65, 0.2, 0.55, 1.15)


def _state(shape=(14, 14, 14)):
    rng = np.random.default_rng(5)
    box = 7.3 * np.eye(3) + 0.15 * rng.standard_normal((3, 3))
    den = 0.25 + 0.1 * rng.random(shape)
    vext = 0.1 * rng.standard_normal(shape)
    return box, den, vext


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module")
def hc_pairs():
    """(JAX, port) HC and revHC instances, each ODE table built once."""
    return {"HuangCarter": (jm.HuangCarter(HC_ARGS),
                            tm.HuangCarter(HC_ARGS)),
            "RevisedHuangCarter": (jm.RevisedHuangCarter(REVHC_ARGS),
                                   tm.RevisedHuangCarter(REVHC_ARGS))}


@pytest.fixture(scope="module")
def hc_prepared(hc_pairs):
    """Each JAX functional prepared once on the 14^3 state (its eager
    prepare is the slowest JAX call here), with its state carried into
    the port's, and its jitted fused sweep: name -> (jf, tf, (E, pot))."""
    box, den, vext = map(jnp.asarray, _state())
    out = {}
    for name, (jf, tf) in hc_pairs.items():
        jf.prepare(box, den)
        tf.load_functional_state(functional_state_from_jax(jf, device="cpu"))
        ref = jax.jit(lambda b, d, v, f=jf.forward: jpot.value_and_potential(
            [f], b, d, v))(box, den, vext)
        out[name] = (jf, tf, ref)
    return out


# -- Huang-Carter and revHC ---------------------------------------------------

def test_hc_table_matches_jax(hc_pairs):
    for jf, tf in hc_pairs.values():
        for a, b in zip(tf.kernel, jf.kernel):
            assert _rel(a.numpy(), b) < 1e-13


@pytest.mark.parametrize("name", ["HuangCarter", "RevisedHuangCarter"])
def test_port_prepare_gives_the_jax_ladder(hc_prepared, name):
    """The port's own prepare on the 14^3 state: the JAX ladder and
    slabs."""
    jf, _, _ = hc_prepared[name]
    tf = type(hc_prepared[name][1])(HC_ARGS if name == "HuangCarter"
                                    else REVHC_ARGS)
    box, den, _ = _state()
    tf.prepare(torch.tensor(box), torch.tensor(den))
    np.testing.assert_array_equal(tf.xi_sparse, jf.xi_sparse)
    assert _rel(tf.aux_arrays()["slabs"].numpy(),
                jf.aux_arrays()["slabs"]) < 1e-13


@pytest.mark.parametrize("name", ["HuangCarter", "RevisedHuangCarter"])
def test_hc_energy_and_potential_match_jax(hc_prepared, name):
    """The direct energy and the fused potential (on the carried ladder
    and slabs) against the JAX package's fused sweep (whose energy equals
    its direct one at 1e-12, ``tests/test_potentials.py``), and the
    port's own autograd of ``forward_static``."""
    _, tf, (E_j, p_j) = hc_prepared[name]
    box, den, vext = _state()
    tb, td, tv = map(torch.tensor, (box, den, vext))
    E_ref = float(E_j)
    with torch.no_grad():
        assert abs(float(tf(tb, td)) - E_ref) <= RTOL * abs(E_ref)
    E_t, p_t = tpot.value_and_potential([tf.forward], tb, td, tv)
    assert abs(float(E_t) - E_ref) <= RTOL * abs(E_ref)
    assert _rel(p_t.numpy(), p_j) < RTOL
    g = get_functional_derivative(tb, td, tf.forward_static)
    assert _rel(p_t.numpy(), g.detach().numpy()) < RTOL


# -- the System paths --------------------------------------------------------

def test_chi_gradient_matches_jax(hc_prepared):
    """The analytic and the autograd chi gradient with the HC term-aux
    (ladder and slabs) against the JAX package's analytic one."""
    box, den, vext = _state()
    jf, tf, _ = hc_prepared["HuangCarter"]
    js = jsys.System.__new__(jsys.System)
    js._terms, js._shape = [jm.Hartree, jf.forward], den.shape
    ts = System.__new__(System)
    ts._terms, ts._shape = [tm.Hartree, tf.forward], den.shape
    chi = np.sqrt(den) * (1.0 + 0.05 * np.random.default_rng(0).random(
        den.shape))
    N = float(np.mean(den) * abs(np.linalg.det(box)))
    E_ref, g_ref = jax.jit(js._chi_value_and_grad_analytic)(
        jnp.asarray(chi), jnp.asarray(box), jnp.asarray(vext), N,
        js._collect_term_aux())
    aux = ts._collect_term_aux()
    assert aux[0] is None and set(aux[1]) == {"ladder", "slabs"}
    args = (torch.tensor(chi), torch.tensor(box), torch.tensor(vext), N, aux)
    for E, g in (ts._chi_value_and_grad_analytic(*args),
                 ts._chi_value_and_grad(*args)):
        assert abs(float(E) - float(E_ref)) <= RTOL * abs(float(E_ref))
        assert _rel(g.numpy(), np.asarray(g_ref).reshape(den.shape)) < RTOL
