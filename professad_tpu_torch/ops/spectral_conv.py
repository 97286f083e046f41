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

Batches: x of shape (B, n0, n1, n2) is B convolutions in ONE kernel call
(still five launches), with K either (B, n0, n1, m2), one per lane, or
(n0, n1, m2), shared by the lanes; B n0 is at most 65535.  This is what
the Pallas kernel computes under ``jax.vmap``.  ``torch.func.vmap`` of the
3-D call reaches the same batched call through the autograd Function's
``vmap`` rule, so a vmapped program (the lane-batched EOS scan) launches
the kernel once per call site whatever the number of lanes.

Dispatch: :func:`spectral_conv` runs :func:`spectral_conv_reference` (the
``torch.fft`` composition) for CPU tensors only.  For CUDA tensors it
launches the kernel or raises: there is no fallback.  ``launches`` counts
the kernel calls (forward and backward, batched or not; each is five CUDA
launches) in this process.

f32 fields are DC-split like ``grid.rfftn``, per lane: the kernel convolves
``x - wmean(x)`` and ``K[0,0,0] * wmean(x)`` is added back, so uniform
fields stay exact.  The backward is the same kernel on the cotangent (the
operator is self-adjoint for any real half-spectrum K).  K is treated as a
constant: a CUDA call with ``K.requires_grad`` raises rather than return
a silent dK = 0.  The Function has no forward-mode rule, so
``torch.func.jvp`` through the kernel raises.
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


def _lane_means(x):
    """The f32 DC split's mean of each 3-D lane, shaped to broadcast."""
    if x.ndim == 3:
        return wmean(x)
    return torch.func.vmap(wmean)(x).reshape(-1, 1, 1, 1)


def _dc(K, m):
    """K[0, 0, 0] times the lanes' means m: the f32 DC split's part."""
    k0 = K[..., 0, 0, 0]
    return (k0.reshape(-1, 1, 1, 1) if K.ndim == 4 else k0) * m


def spectral_conv_reference(x, K):
    """Plain ``torch.fft`` version over the last three axes, with the same
    f32 DC split (per lane for a batch)."""
    shape = tuple(x.shape[-3:])
    dims = (-3, -2, -1)
    if x.dtype == torch.float32:
        m = _lane_means(x)
        y = torch.fft.irfftn(K * torch.fft.rfftn(x - m, dim=dims), s=shape,
                             dim=dims)
        return y + _dc(K, m)
    return torch.fft.irfftn(K * torch.fft.rfftn(x, dim=dims), s=shape,
                            dim=dims)


@functools.lru_cache(maxsize=None)
def build_library():
    """Compile ``csrc/spectral_conv.cu`` (once per source content) and load
    it.  Raises with the compiler's output if the build fails."""
    lib = build("spectral_conv.cu")
    for name in ("spectral_conv_f32", "spectral_conv_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 13 \
            + [ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _widths(shape, itemsize):
    """Tile widths of the z, y and x passes: 128-byte row segments of
    complex values where the axis and the columns allow (a batch takes
    its lanes' widths)."""
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
    device; x is one 3-D field or a (B, n0, n1, n2) batch, K one
    half-spectrum kernel or one per lane."""
    global launches
    n0, n1, n2 = x.shape[-3:]
    B = x.shape[0] if x.ndim == 4 else 1
    kstride = n0 * n1 * (n2 // 2 + 1) if K.ndim == 4 else 0
    lib = build_library()
    fn = lib.spectral_conv_f32 if x.dtype == torch.float32 \
        else lib.spectral_conv_f64
    y = torch.empty_like(x)
    buf = torch.empty((B, n0, n1, n2 // 2 + 1, 2), dtype=x.dtype,
                      device=x.device)
    args = (x.data_ptr(), K.data_ptr(), y.data_ptr(), buf.data_ptr(),
            *_plan_args((n0, n1, n2), x.dtype, x.device), B, kstride,
            torch.cuda.current_stream(x.device).cuda_stream)
    with torch.cuda.device(x.device):
        err = fn(*args)
    if err != 0:
        raise RuntimeError(f"spectral_conv: CUDA launch failed (error {err})")
    launches += 1
    return y


class _SpectralConv(torch.autograd.Function):
    """Kernel with its self-adjoint backward; K is a constant.  The
    ``vmap`` rule turns a vmapped call into one batched kernel call."""

    @staticmethod
    def forward(x, K):
        return _launch(x, K)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[1])

    @staticmethod
    def backward(ctx, g):
        (K,) = ctx.saved_tensors
        return _SpectralConv.apply(g.contiguous(), K), None

    @staticmethod
    def vmap(info, in_dims, x, K):
        xd, kd = in_dims
        if xd is None:
            x = x.expand(info.batch_size, *x.shape)
        else:
            x = x.movedim(xd, 0)
        if kd is not None:
            K = K.movedim(kd, 0).contiguous()
        x = x.contiguous()
        _check(x, K)
        return _SpectralConv.apply(x, K), 0


def _check(x, K):
    """What the kernel takes, with a leading lane axis or none; checked
    for CPU tensors too, so the CPU tests hold the call sites to it."""
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"spectral_conv: dtype {x.dtype} not supported")
    if x.ndim not in (3, 4):
        raise ValueError(f"spectral_conv: x must be 3-D or a (B, n0, n1, "
                         f"n2) batch, got {tuple(x.shape)}")
    n0, n1, n2 = x.shape[-3:]
    half = (n0, n1, n2 // 2 + 1)
    shapes = [half] + ([(x.shape[0],) + half] if x.ndim == 4 else [])
    if tuple(K.shape) not in shapes or K.dtype != x.dtype \
            or K.device != x.device:
        want = " or ".join(str(s) for s in shapes)
        raise ValueError(
            f"spectral_conv: K must be {want} {x.dtype} on {x.device}, got "
            f"{tuple(K.shape)} {K.dtype} on {K.device}")
    if not K.is_contiguous():
        raise ValueError("spectral_conv: K must be contiguous")
    if x.ndim == 4 and x.shape[0] * n0 > 65535:
        raise ValueError(f"spectral_conv: B n0 = {x.shape[0] * n0} lanes' "
                         f"planes exceed the grid's limit of 65535")
    _widths((n0, n1, n2), x.element_size())   # raises on an axis too long


def spectral_conv(x, K):
    """irfftn(K * rfftn(x)) over the last three axes, for real x of
    (n0, n1, n2) or (B, n0, n1, n2) and a real half-spectrum K of
    (n0, n1, m2) or, for a batch, (B, n0, n1, m2)."""
    _check(x, K)
    if x.device.type == "cpu":
        return spectral_conv_reference(x, K)
    if x.device.type != "cuda":
        raise ValueError(f"spectral_conv: no kernel for device {x.device}")
    if K.requires_grad:
        raise ValueError("spectral_conv: K.requires_grad is not supported "
                         "on CUDA (the kernel computes no dK)")
    if x.dtype == torch.float32:
        m = _lane_means(x)
        y = _SpectralConv.apply((x - m).contiguous(), K)
        return y + _dc(K, m)
    return _SpectralConv.apply(x.contiguous(), K)
