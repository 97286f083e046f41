"""The port's neural-network functional and the trainable template's
optimizer against the JAX package, f64 on the CPU: the seeded initial
weights, the energy and its functional derivative with weights carried
across, four ``update_params`` steps against the JAX package's optax Rprop
(one-step lag included), and checkpoints in the JAX package's pickle
layout read both ways.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from professad_tpu.models import NeuralNetworkFunctional as JNeural
from professad_tpu.models import potentials as jpot
from professad_tpu_torch import functional_params_from_jax
from professad_tpu_torch.models import NeuralNetworkFunctional, PauliGaussian
from professad_tpu_torch.models import potentials as tpot
from professad_tpu_torch.ops.autodiff import get_functional_derivative

RTOL = 1e-10


def _state(shape=(14, 14, 14)):
    rng = np.random.default_rng(5)
    box = 7.3 * np.eye(3) + 0.15 * rng.standard_normal((3, 3))
    den = 0.25 + 0.1 * rng.random(shape)
    return box, den


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _params_close(tf, jf, rtol=RTOL):
    assert set(tf.params) == set(jf.params)
    for k, v in jf.params.items():
        got, want = tf.params[k].detach().numpy(), np.asarray(v)
        assert np.allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max()
                           ), k


@pytest.mark.parametrize("widths,seed", [(None, 0), ([8, 5, 3], 11)])
def test_initial_weights_match_jax(widths, seed):
    jf, tf = JNeural(widths, seed=seed), NeuralNetworkFunctional(widths,
                                                                 seed=seed)
    assert tf.init_args == jf.init_args and tf.n_layers == jf.n_layers
    for k, v in jf.params.items():
        assert tf.params[k].dtype == torch.float64
        np.testing.assert_array_equal(tf.params[k].detach().numpy(),
                                      np.asarray(v))


def test_energy_and_derivative_with_carried_weights():
    """Weights perturbed on the JAX side and carried across: the energy at
    rtol 1e-10, and the functional derivative against JAX's gradient.
    The neural functional has no fused potential in either package."""
    jf, tf = JNeural([8, 8], seed=3), NeuralNetworkFunctional([8, 8])
    rng = np.random.default_rng(9)
    jf.params = {k: v + 0.3 * rng.standard_normal(v.shape)
                 for k, v in jf.params.items()}
    tf.load_params(functional_params_from_jax(jf.params))
    box, den = _state()
    jb, jd = jnp.asarray(box), jnp.asarray(den)
    tb, td = torch.tensor(box), torch.tensor(den)
    E_ref = float(jax.jit(jf.forward)(jb, jd))
    with torch.no_grad():
        assert abs(float(tf(tb, td)) - E_ref) <= RTOL * abs(E_ref)
    g_ref = jax.jit(jax.grad(jf.forward, argnums=1))(jb, jd)
    g = get_functional_derivative(tb, td, tf.forward).detach()
    assert _rel(g.numpy() * (abs(np.linalg.det(box)) / den.size), g_ref) \
        < RTOL
    assert not jpot.supported_terms([jf.forward])
    assert not tpot.supported_terms([tf.forward])


def _loss(apply, box, den, target):
    return lambda params: (apply(params, box, den) - target) ** 2


def _jax_loss(jf, shape=(10, 10, 10)):
    """Jitted: the JAX package differentiates it eagerly each step."""
    box, den = _state(shape)
    return jax.jit(_loss(jf.apply, jnp.asarray(box), jnp.asarray(den),
                         -3.0))


def _port_loss(tf, shape=(10, 10, 10)):
    box, den = _state(shape)
    return _loss(tf.apply, torch.tensor(box), torch.tensor(den), -3.0)


def test_update_params_matches_optax():
    """Four steps of the JAX package's ``optax.rprop(0.1)`` (as installed:
    each step applies the update computed a step before, so the first
    leaves the weights unchanged), parameters and losses at rtol 1e-10."""
    jf, tf = JNeural([6, 6], seed=2), NeuralNetworkFunctional([6, 6],
                                                              seed=2)
    jloss, tloss = _jax_loss(jf), _port_loss(tf)
    start = {k: v.detach().clone() for k, v in tf.params.items()}
    for step in range(4):
        L_ref = float(jf.update_params(jloss))
        L = float(tf.update_params(tloss))
        assert abs(L - L_ref) <= RTOL * abs(L_ref)
        _params_close(tf, jf)
        moved = any(not torch.equal(tf.params[k], start[k]) for k in start)
        assert moved == (step > 0)


def test_checkpoints_carry_the_optimizer_state(tmp_path):
    """A JAX checkpoint (optax state inside) read by the port, and the
    port's own checkpoint read back: training continues as the JAX
    package's does."""
    jf = JNeural([6, 6], seed=4)
    jloss = _jax_loss(jf)
    for _ in range(2):
        jf.update_params(jloss)
    jf.save(tmp_path / "jax.pkl")
    tf = NeuralNetworkFunctional.load(tmp_path / "jax.pkl")
    _params_close(tf, jf)
    tf.training_curve.append(1.5)
    tf.save(tmp_path / "port.pkl")
    tf = NeuralNetworkFunctional.load(tmp_path / "port.pkl")
    assert tf.training_curve == [1.5]
    tloss = _port_loss(tf)
    for _ in range(2):
        jf.update_params(jloss)
        tf.update_params(tloss)
        _params_close(tf, jf)


def test_training_helpers():
    """``initialize`` resets the optimizer, ``param_grad`` switches the
    gradients, ``set_device`` moves weights and state; a preset functional
    trains through the same step."""
    pg = PauliGaussian()
    pg.set_PGSL025()
    (step, prev), rest = pg.opt_state
    assert rest == () and set(step) == set(pg.params)
    assert all(float(v) == 0.1 for v in step.values())
    pg.param_grad(False)
    assert not any(p.requires_grad for p in pg.params.values())
    pg.param_grad(True)
    pg.set_device("cpu")
    box, den = _state((8, 8, 8))
    tb, td = torch.tensor(box), torch.tensor(den)
    for _ in range(2):
        pg.update_params(lambda p: (pg.apply(p, tb, td) - 1.0) ** 2)
    assert any(float(v.abs().max()) > 0 for v in pg.opt_state[0][1].values())
    pg.initialize()
    assert all(float(v.abs().max()) == 0 for v in pg.opt_state[0][1].values())
