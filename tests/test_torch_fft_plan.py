"""The host side of the shared-memory Stockham FFT core
(``professad_tpu_torch/ops/fft_plan.py``, ``csrc/fft_core.cuh``), on the CPU.

A small PyTorch executor repeats the core's stages: the same stage plan,
twiddle tables and index arithmetic, and the butterflies written as the CUDA
source writes them.  It is held against ``torch.fft.fft`` in f64 at 1e-12
for every length from 1 to 130 and for 256, which catches index, twiddle and
butterfly faults before the kernels run on a card.  The packing of the
spectral convolution's z passes (two real rows per complex line, the
Hermitian rebuild of the c2r pass) is repeated the same way against
``torch.fft.irfftn``.  Also: the tile widths, the axis limit, and the build
key of ``ops/cuda_build.py``.
"""

import math

import numpy as np
import pytest
import torch

from professad_tpu_torch.ops import cuda_build, fft_plan
from professad_tpu_torch.ops import spectral_conv as sc
from professad_tpu_torch.ops import vpufft as vf

SQ3 = math.sqrt(3.0) / 2
C1, C2 = math.cos(2 * math.pi / 5), math.cos(4 * math.pi / 5)
S1, S2 = math.sin(2 * math.pi / 5), math.sin(4 * math.pi / 5)


def _mj(a, sg):
    """sg * (-i) * a, as fftcore::mj."""
    return torch.complex(sg * a.imag, -sg * a.real)


def _butterfly(a, sg):
    """fftcore::Butterfly<R>: the R-point DFT of the list a, in place."""
    R = len(a)
    if R == 2:
        a[0], a[1] = a[0] + a[1], a[0] - a[1]
    elif R == 3:
        t = a[1] + a[2]
        d = _mj(a[1] - a[2], sg) * SQ3
        b = a[0] - 0.5 * t
        a[0], a[1], a[2] = a[0] + t, b + d, b - d
    elif R == 4:
        t0, t1 = a[0] + a[2], a[0] - a[2]
        t2, t3 = a[1] + a[3], _mj(a[1] - a[3], sg)
        a[0], a[1], a[2], a[3] = t0 + t2, t1 + t3, t0 - t2, t1 - t3
    else:
        t1, t2, t3, t4 = a[1] + a[4], a[2] + a[3], a[1] - a[4], a[2] - a[3]
        b1 = a[0] + C1 * t1 + C2 * t2
        b2 = a[0] + C2 * t1 + C1 * t2
        d1 = _mj(S1 * t3 + S2 * t4, sg)
        d2 = _mj(S2 * t3 - S1 * t4, sg)
        a[0] = a[0] + t1 + t2
        a[1], a[4], a[2], a[3] = b1 + d1, b1 - d1, b2 + d2, b2 - d2


def execute(x, inverse=False):
    """fftcore::fft_tile on the columns of a complex (n, B) tensor."""
    n = x.shape[0]
    plan, tw = fft_plan.stages(n)
    tw = torch.tensor(tw)
    sg = -1.0 if inverse else 1.0
    if inverse:
        tw = tw.conj()
    for R, ns, off in plan:
        m, L = n // R, ns * R
        y = torch.empty_like(x)
        if R in fft_plan.BUTTERFLIES:
            j = torch.arange(m)
            k = j % ns
            v = [x[j + r * m] for r in range(R)]
            for r in range(1, R):
                v[r] = v[r] * tw[off + k * (R - 1) + r - 1][:, None]
            _butterfly(v, sg)
            d = (j - k) * R + k
            for q in range(R):
                y[d + q * ns] = v[q]
        else:
            d = torch.arange(n)
            k, q = d % ns, (d // ns) % R
            j = (d // L) * ns + k
            step = k + q * ns
            y.zero_()
            for r in range(R):
                y += x[j + r * m] * tw[off + (r * step) % L][:, None]
        x = y
    return x


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("n", list(range(1, 131)) + [256])
def test_plan_matches_torch_fft(n):
    rng = np.random.default_rng(n)
    x = torch.tensor(rng.standard_normal((n, 3))
                     + 1j * rng.standard_normal((n, 3)))
    assert _rel(execute(x), torch.fft.fft(x, dim=0)) < 1e-12
    assert _rel(execute(x, inverse=True),
                n * torch.fft.ifft(x, dim=0)) < 1e-12


@pytest.mark.parametrize("n,want", [
    (1, []), (2, [2]), (8, [4, 2]), (128, [4, 4, 4, 2]), (256, [4] * 4),
    (18, [2, 3, 3]), (45, [3, 3, 5]), (61, [61]), (84, [4, 3, 7])])
def test_radices(n, want):
    assert fft_plan.radices(n) == want
    plan, tw = fft_plan.stages(n)
    ns = 1
    for (R, s, off), R2 in zip(plan, want):
        assert (R, s) == (R2, ns)
        ns *= R
    sizes = [s * (R - 1) if R in fft_plan.BUTTERFLIES else s * R
             for R, s, _ in plan]
    assert [off for _, _, off in plan] == [sum(sizes[:i])
                                           for i in range(len(sizes))]
    assert tw.size == sum(sizes)


def _mid(x, axis, inverse=False):
    """execute() along one axis of a complex array."""
    xt = x.movedim(axis, 0)
    shp = xt.shape
    y = execute(xt.reshape(shp[0], -1), inverse).reshape(shp)
    return y.movedim(0, axis)


def _rfft_z(x):
    """rfft_z: two real rows as the real and imaginary parts of one
    complex line, separated after the transform."""
    n0, n1, n2 = x.shape
    m2 = n2 // 2 + 1
    rows = x.reshape(-1, n2)
    if rows.shape[0] % 2:
        rows = torch.cat([rows, torch.zeros(1, n2, dtype=rows.dtype)])
    a, b = rows[0::2], rows[1::2]
    Z = execute(torch.complex(a, b).T).T
    k = torch.arange(m2)
    z1, z2 = Z[:, k], Z[:, (-k) % n2]
    A = 0.5 * (z1 + z2.conj())
    B = -0.5j * (z1 - z2.conj())
    out = torch.stack([A, B], 1).reshape(-1, m2)[: n0 * n1]
    return out.reshape(n0, n1, m2)


def _irfft_z(X, n2):
    """irfft_z: Z = A + i B over the Hermitian extension, the imaginary
    parts of kz = 0 and of the Nyquist column dropped."""
    n0, n1, m2 = X.shape
    rows = X.reshape(-1, m2).clone()
    rows[:, 0] = rows[:, 0].real
    if n2 % 2 == 0:
        rows[:, n2 // 2] = rows[:, n2 // 2].real
    if rows.shape[0] % 2:
        rows = torch.cat([rows, torch.zeros(1, m2, dtype=rows.dtype)])
    full = torch.zeros(rows.shape[0], n2, dtype=rows.dtype)
    full[:, :m2] = rows
    k = torch.arange(1, m2)
    k = k[n2 - k >= m2]
    full[:, n2 - k] = rows[:, k].conj()
    Z = full[0::2] + 1j * full[1::2]
    z = execute(Z.T, inverse=True).T
    y = torch.stack([z.real, z.imag], 1).reshape(-1, n2)[: n0 * n1]
    return y.reshape(n0, n1, n2) / (n0 * n1 * n2)


@pytest.mark.parametrize("shape", [(18, 18, 18), (9, 15, 7), (16, 8, 10),
                                   (1, 4, 2), (7, 5, 1), (5, 3, 11)],
                         ids=str)
def test_spectral_conv_passes_match_irfftn(shape):
    """The five passes of csrc/spectral_conv.cu, repeated with the
    executor, against irfftn(K rfftn(x)) in f64, for a real x and for a
    cotangent-like x whose spectrum is Hermitian only up to rounding."""
    rng = np.random.default_rng(sum(shape))
    x = torch.tensor(rng.standard_normal(shape))
    K = torch.tensor(rng.random((shape[0], shape[1], shape[2] // 2 + 1)))
    a = _rfft_z(x)
    a = _mid(a, 1)
    a = _mid(K * _mid(a, 0), 0, inverse=True)
    a = _mid(a, 1, inverse=True)
    y = _irfft_z(a, shape[2])
    assert _rel(y, torch.fft.irfftn(K * torch.fft.rfftn(x), s=shape)) < 1e-12
    # a half spectrum with imaginary parts on kz = 0 / Nyquist, as c2r sees
    X = torch.tensor(rng.standard_normal(K.shape)
                     + 1j * rng.standard_normal(K.shape))
    y = _irfft_z(_mid(_mid(X, 1, inverse=True), 0, inverse=True), shape[2])
    assert _rel(y, torch.fft.irfftn(X, s=shape)) < 1e-12


@pytest.mark.parametrize("dtype,widths", [
    (torch.float32, (16, 16, 16)), (torch.float64, (8, 8, 8))])
def test_spectral_conv_tiles_at_128(dtype, widths):
    """128-byte row segments of complex values at the main path's shape."""
    x = torch.zeros(128, 128, 128, dtype=dtype)
    assert sc._widths(x.shape, x.element_size()) == widths


@pytest.mark.parametrize("n,inner,width", [
    (16, 256, 32), (128, 8320, 32), (256, 65536, 16), (512, 100, 8),
    (4096, 40, 1), (18, 10, 16), (1, 1, 1)])
def test_core_tiles_fit(n, inner, width):
    """Tile widths for f32 (re, im) planes; every tile fits the core's
    threads and a block's shared memory."""
    w = vf.tile_width(n, inner)
    assert w == width
    assert n * w <= fft_plan.MAX_TILE
    assert n * (w + 1) * 8 <= 232448


def test_axis_limit_holds_on_the_cpu():
    n = fft_plan.MAX_AXIS + 2
    with pytest.raises(ValueError, match="shared memory"):
        sc.spectral_conv(torch.zeros(1, 1, n), torch.zeros(1, 1, n // 2 + 1))
    with pytest.raises(ValueError, match="shared memory"):
        sc.spectral_conv(torch.zeros(n, 1, 2, dtype=torch.float64),
                         torch.zeros(n, 1, 2, dtype=torch.float64))
    x = torch.zeros(fft_plan.MAX_AXIS, 1, 1, dtype=torch.float64)
    assert sc.spectral_conv(x, torch.zeros(fft_plan.MAX_AXIS, 1, 1,
                                           dtype=torch.float64)).shape \
        == x.shape


def test_build_key_covers_headers(tmp_path):
    """An edit to a header of csrc/ changes every source's build key."""
    src = tmp_path / "k.cu"
    hdr = tmp_path / "core.cuh"
    src.write_text('#include "core.cuh"\n')
    hdr.write_text("// v1\n")
    (tmp_path / "notes.txt").write_text("a")
    d0 = cuda_build.source_digest(src, tmp_path)
    assert cuda_build.source_digest(src, tmp_path) == d0
    (tmp_path / "notes.txt").write_text("b")
    assert cuda_build.source_digest(src, tmp_path) == d0
    hdr.write_text("// v2\n")
    d1 = cuda_build.source_digest(src, tmp_path)
    assert d1 != d0
    (tmp_path / "extra.cuh").write_text("")
    assert cuda_build.source_digest(src, tmp_path) != d1
    src.write_text('#include "core.cuh"\n// edit\n')
    assert cuda_build.source_digest(src, tmp_path) not in (d0, d1)
