"""Fused spectral convolution y = irfftn(K * rfftn(x)): CUDA kernel and its
plain PyTorch version.

Replaces the Pallas TPU kernel ``professad_tpu/ops/pallas_fft.py::
spectral_conv`` (its three ``pl.pallas_call`` passes from
``_make_kernels``).  The kernel source is ``csrc/spectral_conv.cu``: five
launches of the shared-memory mixed-radix Stockham core
(``csrc/fft_core.cuh``) over one complex intermediate, in FP32/FP64 FMA
arithmetic (no TF32, no tensor cores); the source note says what bounds it.
The stage plans and tile widths come from ``ops/fft_plan.py``; the longest
axis is ``fft_plan.MAX_AXIS``.  It is built by ``ops/cuda_build.py`` at
first use.

Dispatch: :func:`spectral_conv` runs :func:`spectral_conv_reference` (the
``torch.fft`` composition) for CPU tensors only.  For CUDA tensors it
launches the kernel or raises: there is no fallback.  ``launches`` counts
the kernel calls (forward and backward; each is five CUDA launches) in this
process.

f32 fields are DC-split like ``grid.rfftn``: the kernel convolves
``x - wmean(x)`` and ``K[0,0,0] * wmean(x)`` is added back, so uniform
fields stay exact.  The backward is the same kernel on the cotangent (the
operator is self-adjoint for any real half-spectrum K).  K is treated as a
constant: a CUDA call with ``K.requires_grad`` raises rather than return
a silent dK = 0.
"""

import ctypes
import functools

import torch

from . import fft_plan
from .cuda_build import build
from .grid import wmean

__all__ = ["spectral_conv", "spectral_conv_reference", "build_library",
           "launches"]

launches = 0


def spectral_conv_reference(x, K):
    """Plain ``torch.fft`` version, with the same f32 DC split."""
    shape = tuple(x.shape)
    if x.dtype == torch.float32:
        m = wmean(x)
        y = torch.fft.irfftn(K * torch.fft.rfftn(x - m), s=shape)
        return y + K[0, 0, 0] * m
    return torch.fft.irfftn(K * torch.fft.rfftn(x), s=shape)


@functools.lru_cache(maxsize=None)
def build_library():
    """Compile ``csrc/spectral_conv.cu`` (once per source content) and load
    it.  Raises with the compiler's output if the build fails."""
    lib = build("spectral_conv.cu")
    for name in ("spectral_conv_f32", "spectral_conv_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 12 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _widths(shape, itemsize):
    """Tile widths of the z, y and x passes: 128-byte row segments of
    complex values where the axis and the columns allow."""
    n0, n1, n2 = shape
    m2 = n2 // 2 + 1
    full = 128 // (2 * itemsize)
    return (fft_plan.tile_width(n2, n0 * n1, full, itemsize),
            fft_plan.tile_width(n1, m2, full, itemsize),
            fft_plan.tile_width(n0, n1 * m2, full, itemsize))


@functools.lru_cache(maxsize=None)
def _plan_args(shape, dtype, device):
    """The C entry's plan arguments for one shape: the twiddle and plan
    pointers, stage counts and twiddle counts of the three axes, the sizes
    and the tile widths (the tensors stay alive in
    ``fft_plan.device_plan``'s cache)."""
    plans = [fft_plan.device_plan(n, dtype, device) for n in shape]
    return (*(p[2].data_ptr() for p in plans),
            *(p[0].data_ptr() for p in plans), *(p[1] for p in plans),
            *(p[2].shape[0] for p in plans),
            *shape, *_widths(shape, dtype.itemsize))


def _launch(x, K):
    """One kernel call (five launches) on the current stream of x's
    device."""
    global launches
    n0, n1, n2 = x.shape
    lib = build_library()
    fn = lib.spectral_conv_f32 if x.dtype == torch.float32 \
        else lib.spectral_conv_f64
    y = torch.empty_like(x)
    buf = torch.empty((n0, n1, n2 // 2 + 1, 2), dtype=x.dtype,
                      device=x.device)
    args = (x.data_ptr(), K.data_ptr(), y.data_ptr(), buf.data_ptr(),
            *_plan_args((n0, n1, n2), x.dtype, x.device),
            torch.cuda.current_stream(x.device).cuda_stream)
    with torch.cuda.device(x.device):
        err = fn(*args)
    if err != 0:
        raise RuntimeError(f"spectral_conv: CUDA launch failed (error {err})")
    launches += 1
    return y


class _SpectralConv(torch.autograd.Function):
    """Kernel with its self-adjoint backward; K is a constant."""

    @staticmethod
    def forward(ctx, x, K):
        ctx.save_for_backward(K)
        return _launch(x, K)

    @staticmethod
    def backward(ctx, g):
        (K,) = ctx.saved_tensors
        return _launch(g.contiguous(), K), None


def _check(x, K):
    """What the kernel takes; checked for CPU tensors too, so the CPU
    tests hold the call sites to it."""
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"spectral_conv: dtype {x.dtype} not supported")
    if x.ndim != 3:
        raise ValueError(f"spectral_conv: x must be 3-D, got {tuple(x.shape)}")
    n0, n1, n2 = x.shape
    want = (n0, n1, n2 // 2 + 1)
    if tuple(K.shape) != want or K.dtype != x.dtype or K.device != x.device:
        raise ValueError(
            f"spectral_conv: K must be {want} {x.dtype} on {x.device}, got "
            f"{tuple(K.shape)} {K.dtype} on {K.device}")
    if not K.is_contiguous():
        raise ValueError("spectral_conv: K must be contiguous")
    _widths(x.shape, x.element_size())   # raises on an axis too long


def spectral_conv(x, K):
    """irfftn(K * rfftn(x)) for real 3-D x and a real half-spectrum K."""
    _check(x, K)
    if x.device.type == "cpu":
        return spectral_conv_reference(x, K)
    if x.device.type != "cuda":
        raise ValueError(f"spectral_conv: no kernel for device {x.device}")
    if K.requires_grad:
        raise ValueError("spectral_conv: K.requires_grad is not supported "
                         "on CUDA (the kernel computes no dK)")
    if x.dtype == torch.float32:
        m = wmean(x)
        return _SpectralConv.apply(x - m, K) + K[0, 0, 0] * m
    return _SpectralConv.apply(x.contiguous(), K)
