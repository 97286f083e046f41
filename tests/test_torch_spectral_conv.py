"""The port's spectral convolution (professad_tpu_torch/ops/spectral_conv.py)
against the JAX package's Pallas kernel (interpret mode) and jnp.fft.

On CPU tensors the port runs its plain torch.fft version; the CUDA kernel
itself is compared with that plain version on the card (chip_smoke.py and
tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from professad_tpu.ops.pallas_fft import spectral_conv as jax_spectral_conv
from professad_tpu_torch.ops import spectral_conv as sc

SHAPES = [(16, 16, 16), (8, 16, 12), (16, 8, 10), (18, 18, 18), (9, 15, 7)]


def _case(shape, seed=0):
    rng = np.random.default_rng(seed)
    m2 = shape[2] // 2 + 1
    return (rng.standard_normal(shape),
            rng.random((shape[0], shape[1], m2)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_matches_jax_pallas_f32(shape):
    """Forward and VJP, f32, against the Pallas kernel in interpret mode
    and its custom_vjp; rel 5e-6 (both are f32 DFT compositions with O(n)
    accumulations)."""
    x, K = _case(shape)
    ct = np.random.default_rng(1).standard_normal(shape)

    @jax.jit  # one compile for the forward and the VJP
    def fwd_and_vjp(v, c, Kj):
        y, vjp = jax.vjp(lambda u: jax_spectral_conv(u, Kj, True), v)
        return y, vjp(c)[0]

    ref, g_ref = fwd_and_vjp(jnp.asarray(x, jnp.float32),
                             jnp.asarray(ct, jnp.float32),
                             jnp.asarray(K, jnp.float32))
    xt = torch.tensor(x, dtype=torch.float32, requires_grad=True)
    out = sc.spectral_conv(xt, torch.tensor(K, dtype=torch.float32))
    out.backward(torch.tensor(ct, dtype=torch.float32))
    assert out.dtype == torch.float32
    assert _rel(out.detach().numpy(), ref) < 5e-6
    assert _rel(xt.grad.numpy(), g_ref) < 5e-6


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_matches_jnp_fft_f64(shape):
    """f64 forward and VJP against irfftn(K * rfftn(x)) in jnp.fft, 1e-12."""
    x, K = _case(shape, seed=2)
    xj, Kj = jnp.asarray(x), jnp.asarray(K)
    f = lambda v: jnp.fft.irfftn(Kj * jnp.fft.rfftn(v), shape)
    ct = np.random.default_rng(7).standard_normal(shape)
    ref = f(xj)
    g_ref = jax.vjp(f, xj)[1](jnp.asarray(ct))[0]
    xt = torch.tensor(x, requires_grad=True)
    out = sc.spectral_conv(xt, torch.tensor(K))
    out.backward(torch.tensor(ct))
    assert out.dtype == torch.float64
    assert _rel(out.detach().numpy(), ref) < 1e-12
    assert _rel(xt.grad.numpy(), g_ref) < 1e-12


def test_dc_split_exact_on_uniform_fields():
    """A uniform f32 field convolves to the exactly uniform K[0,0,0] * c:
    the DC split keeps the FFT's rounding out of the k=0 channel."""
    shape = (24, 24, 24)
    c = np.float32(0.0296)
    K = torch.tensor(_case(shape)[1], dtype=torch.float32)
    x = torch.full(shape, float(c), dtype=torch.float32)
    y = sc.spectral_conv(x, K).numpy()
    expect = np.float32(K[0, 0, 0].item() * c)
    assert np.all(y == y.flat[0]), np.ptp(y)
    assert abs(float(y.flat[0]) - float(expect)) <= np.spacing(expect)


def test_cpu_tensors_never_launch():
    before = sc.launches
    x, K = _case((9, 15, 7))
    sc.spectral_conv(torch.tensor(x), torch.tensor(K))
    sc.spectral_conv(torch.tensor(x, dtype=torch.float32),
                     torch.tensor(K, dtype=torch.float32))
    assert sc.launches == before == 0



BATCH_SHAPES = [(3, 8, 9, 10), (2, 9, 15, 7)]


def _batch(shape, dtype, seed=5):
    rng = np.random.default_rng(seed)
    B, n0, n1, n2 = shape
    x = torch.tensor(rng.standard_normal(shape), dtype=dtype)
    K = torch.tensor(rng.random((B, n0, n1, n2 // 2 + 1)), dtype=dtype)
    return x, K


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("shape", BATCH_SHAPES, ids=str)
def test_batched_plain_matches_lane_loop(shape, dtype):
    """A (B, n0, n1, n2) batch against a loop of 3-D calls, with one K per
    lane and with one shared K (the f32 DC split per lane): equal to the
    last bit when torch runs two or more intra-op threads; on one, MKL's
    batched c2r rounds apart from its 3-D one (4.8e-7 absolute in f32,
    6.7e-16 in f64); bound 1e-6 (f32) and 1e-14 (f64) relative."""
    tol = 1e-6 if dtype == torch.float32 else 1e-14
    x, K = _batch(shape, dtype)
    for Kb, Kl in ((K, list(K)), (K[0], [K[0]] * shape[0])):
        y = sc.spectral_conv(x, Kb)
        loop = torch.stack([sc.spectral_conv(x[b], Kl[b])
                            for b in range(shape[0])])
        assert y.shape == x.shape and y.dtype == dtype
        assert _rel(y.numpy(), loop.numpy()) < tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_vmap_matches_lane_loop(dtype):
    """torch.func.vmap of the 3-D call, K batched or shared, is the batched
    call to the last bit, and matches the loop of 3-D calls at the batched
    test's bounds (on one intra-op thread MKL's batched c2r rounds apart
    from its 3-D one in f32); in f32 the DC split of a uniform lane stays
    exact under vmap."""
    tol = 1e-6 if dtype == torch.float32 else 1e-14
    x, K = _batch((3, 8, 9, 10), dtype)
    x[1] = 0.0296
    loop = torch.stack([sc.spectral_conv(x[b], K[b]) for b in range(3)])
    y = torch.func.vmap(sc.spectral_conv)(x, K)
    assert torch.equal(y, sc.spectral_conv(x, K))
    assert _rel(y.numpy(), loop.numpy()) < tol
    if dtype == torch.float32:
        assert torch.all(y[1] == y[1].flatten()[0])
    shared = torch.func.vmap(sc.spectral_conv, in_dims=(0, None))(x, K[0])
    loop = torch.stack([sc.spectral_conv(x[b], K[0]) for b in range(3)])
    assert torch.equal(shared, sc.spectral_conv(x, K[0]))
    assert _rel(shared.numpy(), loop.numpy()) < tol


def test_batched_shape_and_dtype_raise():
    x, K = _batch((3, 8, 9, 10), torch.float64)
    with pytest.raises(ValueError, match="K must be"):
        sc.spectral_conv(x, K[:2])             # lanes disagree
    with pytest.raises(ValueError, match="K must be"):
        sc.spectral_conv(x, K[..., :5])        # not the half spectrum
    with pytest.raises(ValueError, match="K must be"):
        sc.spectral_conv(x, K.float())         # dtypes differ
    with pytest.raises(ValueError, match="3-D or"):
        sc.spectral_conv(x[None], K)           # 5-D
    with pytest.raises(ValueError, match="not supported"):
        sc.spectral_conv(x.to(torch.float16), K.to(torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        sc.spectral_conv(x, K.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="65535"):
        sc.spectral_conv(torch.zeros((8200, 8, 2, 2), dtype=torch.float64),
                         torch.zeros((8, 2, 2), dtype=torch.float64))
