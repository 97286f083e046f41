"""The port's second-derivative getters against the JAX package's own
getters on one state, f64 on the CPU, rtol 5e-6: ``bulk_modulus``,
``elastic_constants``, ``force_constants``, the ``gs_property_fn``
gradient and ``gs_volume_property_fn``'s P and K with their parameter
gradients, plus ``pressure`` and ``enthalpy`` at 1e-10.  The JAX getters
run CG inside ``jacfwd`` and compile for minutes each, so this file is
marked slow and left out of tier-1; run it with
``python -m pytest -m slow tests/test_torch_implicit_getters.py``.

The JAX getters differentiate through a custom_jvp frozen at chi0 and add
terms of the order of the density residual that the port's closed form
E_tt - b^T H^+ b drops; 5e-6 covers that gap."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
import jax

from professad_tpu import system as jsys
from professad_tpu import models as jm
from professad_tpu_torch import System, system_state_from_jax
from professad_tpu_torch import models as tm
from paths import pot

pytestmark = pytest.mark.slow

SHAPE = (8, 8, 8)
FRAC = np.array([[0.0, 0.0, 0.0], [0.53, 0.48, 0.51]])


@pytest.fixture(scope="module")
def pair():
    def terms(m, kinetic):
        return [m.IonIon, m.IonElectron, m.Hartree, kinetic,
                m.PerdewBurkeErnzerhof]
    jpg = jm.PauliGaussian((40.0 / 27.0, 0.25, 0.4, 0.2))
    js = jsys.System(jnp.asarray(3.48 * np.eye(3)), SHAPE,
                     [["Li", pot("li.gga.recpot"), jnp.asarray(FRAC)]],
                     terms(jm, jpg), units="a", coord_type="fractional")
    js.optimize_density(ntol=1e-10)
    pg = tm.PauliGaussian((40.0 / 27.0, 0.25, 0.4, 0.2))
    ts = System(3.48 * np.eye(3), SHAPE, [["Li", pot("li.gga.recpot"), FRAC]],
                terms(tm, pg), units="a", coord_type="fractional",
                device="cpu")
    ts.load_state_dict(system_state_from_jax(js.state_dict(), device="cpu"))
    return js, jpg, ts, pg


def _rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return np.max(np.abs(a - ref)) / np.max(np.abs(ref))


def test_pressure_enthalpy(pair):
    js, _, ts, _ = pair
    assert _rel(ts.pressure(), js.pressure()) <= 1e-10
    assert _rel(ts.enthalpy(), js.enthalpy()) <= 1e-10


def test_bulk_modulus(pair):
    js, _, ts, _ = pair
    assert _rel(ts.bulk_modulus(), js.bulk_modulus()) <= 5e-6


def test_elastic_constants(pair):
    js, _, ts, _ = pair
    assert _rel(ts.elastic_constants().numpy(),
                js.elastic_constants()) <= 5e-6


def test_force_constants(pair):
    js, _, ts, _ = pair
    assert _rel(ts.force_constants([1], "Ha/b2").numpy(),
                js.force_constants([1], "Ha/b2")) <= 5e-6


def test_gs_property_fn_grad(pair):
    js, jpg, ts, pg = pair
    ref = jax.grad(js.gs_property_fn(jpg))(jpg.params)
    keys = sorted(ref)
    got = torch.autograd.grad(ts.gs_property_fn(pg)(pg.params),
                              [pg.params[k] for k in keys])
    assert _rel([float(g) for g in got], [float(ref[k]) for k in keys]) \
        <= 5e-6


@pytest.mark.parametrize("prop", ["pressure", "bulk_modulus"])
def test_gs_volume_property_fn_grad(pair, prop):
    """P or K and their parameter gradients through the Newton map (the
    third mixed derivative for K) against the JAX package's
    ``gs_volume_property_fn`` on the same state."""
    js, jpg, ts, pg = pair
    jfn = js.gs_volume_property_fn(jpg, property=prop)
    ref = jax.grad(jfn)(jpg.params)
    keys = sorted(ref)
    val = ts.gs_volume_property_fn(pg, property=prop)(pg.params)
    assert _rel(float(val.detach()), float(jfn(jpg.params))) <= 5e-6
    got = torch.autograd.grad(val, [pg.params[k] for k in keys])
    assert _rel([float(g) for g in got], [float(ref[k]) for k in keys]) \
        <= 5e-6
