"""The port's Stockham FFT entry points (``professad_tpu_torch/ops/
vpufft.py``) against the JAX module's Pallas kernels run in interpret mode,
on the CPU, where the port's wrappers run their torch.fft versions.  The
same numpy inputs go to both; the bounds are those of
tests/test_pallas_fft.py: rel 1e-6, and 1e-5 on the round trips."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from professad_tpu.ops import vpufft as J
from professad_tpu_torch.ops import vpufft as T

# name -> number of (n, B) f32 inputs
SUBLANE = {"fft_sublane": 2, "ifft_sublane": 2, "fft_sublane_real": 1,
           "ifft_sublane_real_out": 2, "sublane_conv": 3}


def _inputs(shape, count, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for _ in range(count)]


def _rel(out, ref):
    out = out if isinstance(out, tuple) else (out,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    scale = max(np.abs(np.asarray(r)).max() for r in ref)
    return max(np.abs(o.numpy() - np.asarray(r)).max()
               for o, r in zip(out, ref)) / scale


@pytest.mark.parametrize("shape", [(32, 256), (16, 256)], ids=str)
@pytest.mark.parametrize("name", list(SUBLANE))
def test_sublane_entry_matches_jax(name, shape):
    xs = _inputs(shape, SUBLANE[name])
    ref = getattr(J, name)(*map(jnp.asarray, xs), interpret=True)
    out = getattr(T, name)(*map(torch.tensor, xs))
    assert _rel(out, ref) < 1e-6


@pytest.mark.parametrize("name", ["fft_mid", "ifft_mid"])
def test_mid_entry_matches_jax(name):
    xs = _inputs((16, 16, 16), 2, seed=1)
    ref = getattr(J, name)(*map(jnp.asarray, xs), interpret=True)
    out = getattr(T, name)(*map(torch.tensor, xs))
    assert _rel(out, ref) < 1e-6


@pytest.mark.parametrize("fwd,inv,nargs", [
    ("fft_sublane", "ifft_sublane", 2),
    ("fft_sublane_real", "ifft_sublane_real_out", 1),
    ("fft_mid", "ifft_mid", 2),
], ids=["complex", "real", "mid"])
def test_round_trips(fwd, inv, nargs):
    shape = (16, 16, 16) if fwd == "fft_mid" else (32, 256)
    xs = [torch.tensor(x) for x in _inputs(shape, nargs, seed=2)]
    back = getattr(T, inv)(*getattr(T, fwd)(*xs))
    back = back if isinstance(back, tuple) else (back,)
    for b, x in zip(back, xs):
        assert float((b - x).abs().max()) < 1e-5


def _hermitian_kernel(n, seed=3):
    rng = np.random.default_rng(seed)
    Kf = rng.standard_normal((n, n, n))
    idx = (-np.arange(n)) % n
    return (0.5 * (Kf + Kf[np.ix_(idx, idx, idx)])).astype(np.float32)


def test_conv3_bfly_matches_jax_and_numpy():
    n = 16
    x = _inputs((n, n, n), 1, seed=4)[0]
    Kf = _hermitian_kernel(n)
    k_t = np.ascontiguousarray(np.transpose(Kf, (2, 1, 0)))
    ref_np = np.fft.ifftn(Kf * np.fft.fftn(x)).real
    ref_j = np.asarray(J.conv3_bfly(jnp.asarray(x), jnp.asarray(k_t),
                                    interpret=True))
    y = T.conv3_bfly(torch.tensor(x), torch.tensor(k_t)).numpy()
    scale = np.abs(ref_np).max()
    assert np.abs(y - ref_j).max() / scale < 1e-6
    assert np.abs(y - ref_np).max() / scale < 1e-6
    y_ref = T.conv3_bfly_reference(torch.tensor(x), torch.tensor(k_t))
    assert np.abs(y_ref.numpy() - ref_np).max() / scale < 1e-6


@pytest.mark.parametrize("name", list(SUBLANE) + ["fft_mid"])
def test_non_power_of_two_axis_raises(name):
    shape = (2, 12, 4) if name == "fft_mid" else (24, 128)
    xs = [torch.zeros(shape) for _ in range(SUBLANE.get(name, 2))]
    with pytest.raises(ValueError, match="power-of-two"):
        getattr(T, name)(*xs)


def test_wrapper_checks_hold_on_the_cpu():
    a, b = (torch.tensor(x) for x in _inputs((16, 64), 2))
    with pytest.raises(ValueError, match="float32"):
        T.fft_sublane(a.double(), b.double())
    with pytest.raises(ValueError, match="contiguous"):
        T.fft_sublane(a.t().contiguous().t(), b)
    with pytest.raises(ValueError, match="must be"):
        T.sublane_conv(a, b, a[:8].contiguous())
    with pytest.raises(ValueError, match="shared memory"):
        T.fft_sublane_real(torch.zeros(8192, 2))
    with pytest.raises(ValueError, match="k_t must be"):
        T.conv3_bfly(torch.zeros(8, 8, 4), torch.zeros(8, 8, 4))


@pytest.mark.parametrize("n,inner,width", [
    (16, 256, 32), (128, 8320, 32), (256, 65536, 16), (512, 100, 8),
    (256, 3, 4), (4096, 40, 1), (1, 1, 1)])
def test_tile_width(n, inner, width):
    """Tiles of at most 32 columns whose shared memory stays within 72 KB
    (three blocks on an SM), cut down to the column count."""
    w = T.tile_width(n, inner)
    assert w == width
    assert w == 1 or 16 * n * (w + 1) <= 72 * 1024
