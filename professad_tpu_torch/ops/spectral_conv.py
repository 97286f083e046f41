"""Fused spectral convolution y = irfftn(K * rfftn(x)): CUDA kernel and its
plain PyTorch version.

Replaces the Pallas TPU kernel ``professad_tpu/ops/pallas_fft.py::
spectral_conv`` (its three ``pl.pallas_call`` passes from
``_make_kernels``).  The kernel source is ``csrc/spectral_conv.cu``; it is a
direct-DFT design in FP32/FP64 FMA arithmetic (no TF32, no tensor cores),
bound by FMA issue and L1/L2 re-reads rather than by device memory — the
source note says how.  It is built by ``ops/cuda_build.py`` at first use.

Dispatch: :func:`spectral_conv` runs :func:`spectral_conv_reference` (the
``torch.fft`` composition) for CPU tensors only.  For CUDA tensors it
launches the kernel or raises: there is no fallback.  ``launches`` counts
the kernel launches (forward and backward) in this process.

f32 fields are DC-split like ``grid.rfftn``: the kernel convolves
``x - wmean(x)`` and ``K[0,0,0] * wmean(x)`` is added back, so uniform
fields stay exact.  The backward is the same kernel on the cotangent (the
operator is self-adjoint for any real half-spectrum K).  K is treated as a
constant: a CUDA call with ``K.requires_grad`` raises rather than return
a silent dK = 0.
"""

import ctypes
import functools

import numpy as np
import torch

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
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _twiddles(n, dtype, device):
    """(n, 2) table of cos, sin(2 pi j / n), computed in double."""
    ang = 2.0 * np.pi * np.arange(n) / n
    tab = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    return torch.as_tensor(tab, dtype=dtype, device=device).contiguous()


def _launch(x, K):
    """One kernel launch on the current stream of x's device."""
    global launches
    n0, n1, n2 = x.shape
    m2 = n2 // 2 + 1
    lib = build_library()
    fn = lib.spectral_conv_f32 if x.dtype == torch.float32 \
        else lib.spectral_conv_f64
    y = torch.empty_like(x)
    buf_a = torch.empty((n0, n1, m2, 2), dtype=x.dtype, device=x.device)
    buf_b = torch.empty_like(buf_a)
    tw = [_twiddles(n, x.dtype, x.device) for n in (n0, n1, n2)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), K.data_ptr(), y.data_ptr(), buf_a.data_ptr(),
                 buf_b.data_ptr(), tw[0].data_ptr(), tw[1].data_ptr(),
                 tw[2].data_ptr(), n0, n1, n2, stream)
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
