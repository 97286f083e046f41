"""The port's xi-ladder machinery against the JAX package, f64 on the CPU:
the ladder interpolation, the field-dependent convolution and its ladder
transforms, and YukawaGGA, the semi-local functional built on them, with
its fused potentials.  Huang-Carter and revHC are held in
``test_torch_huang_carter.py``, the ladder terms' density optimization,
directional derivatives and f32 tier in ``test_torch_ladder_paths.py``.

Inputs come from numpy with a seed (the 14^3 random states of
``tests/test_potentials.py``) and go through both packages, at rtol 1e-10
for the functionals and 1e-13 for the transforms.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from professad_tpu import models as jm
from professad_tpu.models import potentials as jpot
from professad_tpu.ops import fieldconv as jfc
from professad_tpu.ops import interp as jinterp
from professad_tpu.ops.grid import wavevecs as jwavevecs
from professad_tpu_torch import models as tm
from professad_tpu_torch.models import potentials as tpot
from professad_tpu_torch.ops import fieldconv as tfc
from professad_tpu_torch.ops import interp as tinterp
from professad_tpu_torch.ops.autodiff import get_functional_derivative
from professad_tpu_torch.ops.grid import wavevecs

RTOL = 1e-10


def _state(shape=(14, 14, 14)):
    rng = np.random.default_rng(5)
    box = 7.3 * np.eye(3) + 0.15 * rng.standard_normal((3, 3))
    den = 0.25 + 0.1 * rng.random(shape)
    vext = 0.1 * rng.standard_normal(shape)
    return box, den, vext


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


# -- interpolation and the field-dependent convolution ----------------------

@pytest.mark.parametrize("L", [9, 40], ids=["dense", "gather"])
def test_interpolate_kernel_matches_jax(L):
    """Both branches: ladders up to 32 rungs contract densely, longer ones
    gather."""
    rng = np.random.default_rng(1)
    lad = np.cumsum(0.1 + rng.random(L))
    f = rng.standard_normal((5, 6, 7, L))
    xis = lad[0] + (lad[-1] - lad[0]) * rng.random((5, 6, 7))
    ref = jax.jit(jinterp.interpolate_kernel)(
        jnp.asarray(lad), jnp.asarray(f), jnp.asarray(xis))
    out = tinterp.interpolate_kernel(torch.tensor(lad), torch.tensor(f),
                                     torch.tensor(xis))
    assert _rel(out.numpy(), ref) < 1e-13


@pytest.mark.parametrize("mode,kappa", [("geometric", 1.2),
                                        ("arithmetic", 0.3)])
def test_xi_ladder_matches_jax(mode, kappa):
    for lo, hi in ((0.37, 4.1), (1.0, 1.0), (2.4, 57.3)):
        np.testing.assert_array_equal(
            tfc.xi_ladder(lo, hi, kappa, mode),
            jfc.xi_ladder(lo, hi, kappa, mode))


def _yukawa_kernel(k2, lad):
    return 4.0 * np.pi / (k2[..., None] + lad ** 2)


def test_field_dependent_convolution_matches_jax():
    """The port sizes its own ladder from xi; the JAX call is given that
    ladder, and equals its own sizing (``xi_ladder`` is held above)."""
    box, den, _ = _state()
    xis = 1.0 + 3.0 * den
    out = tfc.field_dependent_convolution(
        wavevecs(torch.tensor(box), den.shape)[3], _yukawa_kernel,
        torch.tensor(den), torch.tensor(xis), kappa=1.2, mode="geometric")
    lad = jfc.xi_ladder(xis.min(), xis.max(), 1.2, "geometric")
    ref = jax.jit(lambda b, d, x: jfc.field_dependent_convolution(
        jwavevecs(b, den.shape)[3], _yukawa_kernel, d, x, xi_sparse=lad))(
        jnp.asarray(box), jnp.asarray(den), jnp.asarray(xis))
    assert _rel(out.numpy(), ref) < RTOL


def test_ladder_transforms_match_jax():
    rng = np.random.default_rng(2)
    shape, L = (10, 12, 9), 6
    W = rng.random((10, 12, 5, L))
    g = rng.standard_normal(shape)
    B = rng.standard_normal(shape + (L,))
    ref_c = jfc.ladder_convolution(jnp.asarray(W), jnp.asarray(g), shape)
    ref_a = jfc.ladder_adjoint(jnp.asarray(W), jnp.asarray(B), shape)
    out_c = tfc.ladder_convolution(torch.tensor(W), torch.tensor(g), shape)
    out_a = tfc.ladder_adjoint(torch.tensor(W), torch.tensor(B), shape)
    assert tuple(out_c.shape) == shape + (L,)
    assert _rel(out_c.numpy(), ref_c) < 1e-13
    assert _rel(out_a.numpy(), ref_a) < 1e-13


def test_ladder_transforms_f32_dc_split_exact():
    """A uniform f32 field through the ladder transforms with flat slabs
    stays exactly uniform per slab: the per-slab DC split keeps each
    slab's mean out of its low modes."""
    shape, L = (24, 24, 24), 5
    val = 0.031415927
    g = torch.full(shape, val, dtype=torch.float32)
    W = torch.ones((24, 24, 13, L), dtype=torch.float32)
    out = tfc.ladder_convolution(W, g, shape)
    assert tuple(out.shape) == shape + (L,)
    assert bool((out == out.reshape(-1)[0]).all())
    assert abs(float(out.reshape(-1)[0]) - val) < 1e-6
    B = torch.full(shape + (L,), val, dtype=torch.float32)
    out2 = tfc.ladder_adjoint(W, B, shape)
    assert tuple(out2.shape) == shape
    assert bool((out2 == out2.reshape(-1)[0]).all())
    assert abs(float(out2.reshape(-1)[0]) - L * val) < 1e-5


def test_spline_matches_naive():
    """The spline method against the exact per-point convolution with the
    bound of ``tests/test_field_dependent_convolution_spline.py``
    (``np.allclose(atol=1e-10)``, whose default rtol 1e-5 is what binds:
    the spline's error here is 5.3e-6 on values of 3 to 13, in both
    packages), and the port's naive oracle against the JAX package's."""
    shape = (20, 20, 20)
    box = 2.0 * np.eye(3)
    xf, yf, zf = np.meshgrid(*(np.arange(s) / s for s in shape),
                             indexing="ij")
    r = 2.0 * np.sqrt(xf * xf + yf * yf + zf * zf)
    xis = torch.tensor(np.cos(r) ** 2 + 1.0)
    g = xis ** (1.0 / 3.0)
    k2 = wavevecs(torch.tensor(box), shape)[3]
    spline = tfc.field_dependent_convolution(k2, _yukawa_kernel, g, xis,
                                             kappa=0.01)
    naive = tfc.field_dependent_convolution_naive(k2, _yukawa_kernel, g, xis)
    assert np.allclose(spline.numpy(), naive.numpy(), atol=1e-10)
    small = tuple(slice(0, 6) for _ in range(3))
    gs, xs = g[small].contiguous(), xis[small].contiguous()
    ref = jax.jit(lambda b, g_, x_: jfc.field_dependent_convolution_naive(
        jwavevecs(b, gs.shape)[3], _yukawa_kernel, g_, x_, batch=64))(
        jnp.asarray(box), jnp.asarray(gs.numpy()), jnp.asarray(xs.numpy()))
    out = tfc.field_dependent_convolution_naive(
        wavevecs(torch.tensor(box), gs.shape)[3], _yukawa_kernel, gs, xs,
        batch=64)
    assert _rel(out.numpy(), ref) < 1e-13


YUKAWA = {
    "yuk1": lambda y: y.set_yuk1(), "yuk2": lambda y: y.set_yuk2(),
    "yuk3": lambda y: y.set_yuk3(), "yuk4": lambda y: y.set_yuk4(),
    "yuk2beta": lambda y: y.set_yuk2beta(1.3, 1.1),
    "yuk3beta": lambda y: y.set_yuk3beta(1.3, 1.1, a=2.0),
}


@pytest.mark.parametrize("preset", list(YUKAWA))
def test_yukawa_presets_match_jax(preset):
    """Every tagged preset: the port's own ladder is the JAX one; the
    direct energy and the fused potential (five chains) against the JAX
    package's fused sweep, and the port's autograd."""
    box, den, vext = _state()
    jy, ty = jm.YukawaGGA(), tm.YukawaGGA()
    YUKAWA[preset](jy)
    YUKAWA[preset](ty)
    jb, jd, jv = map(jnp.asarray, (box, den, vext))
    tb, td, tv = map(torch.tensor, (box, den, vext))
    jy.prepare(jb, jd)
    ty.prepare(tb, td)
    np.testing.assert_array_equal(ty.xi_sparse, jy.xi_sparse)
    assert tpot.supported_terms([ty.forward])
    E_j, p_j = jax.jit(lambda b, d, v: jpot.value_and_potential(
        [jy.forward], b, d, v))(jb, jd, jv)
    E_ref = float(E_j)
    with torch.no_grad():
        assert abs(float(ty(tb, td)) - E_ref) <= RTOL * abs(E_ref)
    E_t, p_t = tpot.value_and_potential([ty.forward], tb, td, tv)
    assert abs(float(E_t) - E_ref) <= RTOL * abs(E_ref)
    assert _rel(p_t.numpy(), p_j) < RTOL
    g = get_functional_derivative(tb, td, ty.forward_static)
    assert _rel(p_t.numpy(), g.detach().numpy()) < RTOL


def test_yukawa_naive_descriptor_matches_spline():
    """spline=False takes the exact per-point convolution; on a smooth
    density it agrees with the ladder method."""
    box, den, _ = _state((8, 8, 8))
    ty = tm.YukawaGGA()
    ty.kappa = 1.02
    tb, td = torch.tensor(box), torch.tensor(den)
    with torch.no_grad():
        E_spline = float(ty(tb, td))
        ty.spline = False
        assert not tpot.supported_terms([ty.forward])
        E_naive = float(ty(tb, td))
    assert abs(E_spline - E_naive) < 1e-6 * abs(E_naive)


def test_yukawa_custom_callable_rejected():
    y = tm.YukawaGGA((1.0, 1.0, lambda y, s2, q: y * y, 1.2))
    assert not tpot.supported_terms([y.forward])
    box, den, vext = _state((6, 6, 6))
    with pytest.raises(KeyError):
        tpot.value_and_potential([y.forward], *map(torch.tensor,
                                                   (box, den, vext)))


