"""The port's training example (examples/torch_parameterized_functionals.py)
on the CPU at reduced sizes: 3 epochs of each of its three trainings.  The
Pauli-Gaussian losses against the JAX package's (its
``get_functional_derivative`` and ``update_params`` on the same density)
within 1e-8 relative; the neural and ground-state trainings are held to
the JAX package by ``test_torch_neural.py`` and ``test_torch_gs_training.py``.
Also the Pauli-Gaussian parameter gradient where a parameter is 0, which
the example's training starts from.
"""

import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from professad_tpu.models import PauliGaussian as JPauliGaussian
from professad_tpu.models import WangTeter as JWangTeter
from professad_tpu.ops.autodiff import (
    get_functional_derivative as jfunctional_derivative)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
sys.path.insert(0, EXAMPLES)

import torch_parameterized_functionals as train  # noqa: E402

EPOCHS = 3
TRAIN_SIZES = dict(n=12, gs_n=10, pg_epochs=EPOCHS, nn_epochs=EPOCHS,
                   gs_epochs=EPOCHS)


@pytest.fixture(scope="module")
def training():
    return train.main(device="cpu", **TRAIN_SIZES)


def _jax_pg_losses():
    """The JAX package's Pauli-Gaussian training on the port's density."""
    _, den, bv, _ = train.wt_reference("cpu", TRAIN_SIZES["n"])
    jden, jbv = jnp.asarray(den.numpy()), jnp.asarray(bv.numpy())
    v_target = jfunctional_derivative(jbv, jden, JWangTeter)
    pg = JPauliGaussian()

    @jax.jit
    def loss(params):
        v_pred = jfunctional_derivative(
            jbv, jden, lambda b, n: pg.apply(params, b, n))
        return jnp.mean((v_pred - v_target) ** 2)

    return [float(pg.update_params(loss)) for _ in range(EPOCHS)]


def test_pauli_gaussian_losses_match_jax(training):
    want = _jax_pg_losses()
    got = training["pg_losses"]
    assert len(got) == EPOCHS
    np.testing.assert_allclose(got, want, rtol=1e-8)
    assert got[-1] < got[0]


def test_neural_and_ground_state_training(training):
    nn = training["nn_losses"]
    # the reference's Rprop applies each update a step late
    assert len(nn) == EPOCHS and nn[1] == nn[0] and nn[-1] < nn[0]
    assert training["checkpoint_ok"]
    gs = training["gs_losses"]
    assert len(gs) == EPOCHS and np.all(np.isfinite(gs))
    assert set(training["gs_params"]) == {"mu", "beta", "lamb", "sigma"}


def test_pauli_gaussian_param_grad_at_zero_matches_jax():
    """d|p|/dp at p = 0 is +1 in the JAX package (``jnp.abs``), so lambda
    and sigma, which start at 0, move in training."""
    from professad_tpu_torch.models import PauliGaussian
    rng = np.random.default_rng(2)
    box = 7.0 * np.eye(3) + 0.2 * rng.standard_normal((3, 3))
    den = 0.02 + 0.01 * rng.random((8, 8, 8))
    jpg, pg = JPauliGaussian(), PauliGaussian()
    want = jax.grad(lambda p: jpg.apply(p, jnp.asarray(box),
                                        jnp.asarray(den)))(jpg.params)
    E = pg.apply(pg.params, torch.tensor(box), torch.tensor(den))
    got = torch.autograd.grad(E, [pg.params[k] for k in want])
    for k, g in zip(want, got):
        assert abs(float(g) - float(want[k])) <= 1e-10 * abs(float(want[k]))
    assert float(want["lamb"]) != 0.0 and float(want["sigma"]) != 0.0
