"""Stockham FFTs along one axis of f32 (re, im) planes: the CUDA kernel
and its plain PyTorch versions.

Replaces the five Pallas TPU kernels of ``professad_tpu/ops/vpufft.py``
(``_fft_call``, ``_fft_real_call``, ``_ifft_real_out_call``,
``_sublane_conv_call``, ``_fft_mid_call``) with one templated CUDA kernel,
``csrc/stockham.cu`` on the shared-memory core of ``csrc/fft_core.cuh``: a
tile of n rows x W columns is loaded once into shared memory, the radix-4
stages of ``ops/fft_plan.py`` run there, and the tile is written once.  It
is bound by device memory; the source note says how.  It is built by
``ops/cuda_build.py`` at first use.

The public functions keep the JAX module's names and layouts:
``fft_sublane`` / ``ifft_sublane`` (axis 0 of an (n, B) batch, the inverse
scaled by 1/n), ``fft_sublane_real`` (real input), ``ifft_sublane_real_out``
(real part of the inverse), ``sublane_conv`` (forward FFT, times a real
full-length k, inverse FFT, fused), ``fft_mid`` / ``ifft_mid`` (axis 1 of an
(n0, n1, n2) cube), and ``conv3_bfly``, the composition
``ifftn(K fftn(x)).real`` over them with the kernel given in (z, y, x)
layout.  The transform axis must be a power of two.

Dispatch: each function runs its ``*_reference`` (``torch.fft``) for CPU
tensors only; for CUDA tensors it launches the kernel or raises, with no
fallback.  The inputs are checked on the CPU too (float32, shape,
contiguity, a power-of-two axis that fits in shared memory), so the CPU
tests hold the callers to what the kernel takes.  Like the JAX functions,
these have no gradient: a CUDA input that requires grad raises.
``launches`` counts the kernel launches per TPU kernel in this process.
"""

import ctypes
import functools

import torch

from . import fft_plan
from .cuda_build import build

__all__ = ["fft_sublane", "ifft_sublane", "fft_sublane_real",
           "ifft_sublane_real_out", "sublane_conv", "fft_mid", "ifft_mid",
           "conv3_bfly", "fft_sublane_reference", "ifft_sublane_reference",
           "fft_sublane_real_reference", "ifft_sublane_real_out_reference",
           "sublane_conv_reference", "fft_mid_reference",
           "ifft_mid_reference", "conv3_bfly_reference", "tile_width",
           "build_library", "launches"]

# one count per TPU kernel replaced (forward and inverse share a kernel)
launches = {"fft_sublane": 0, "fft_sublane_real": 0,
            "ifft_sublane_real_out": 0, "sublane_conv": 0, "fft_mid": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ENTRIES = {
    "stockham_fft_sublane": [_P] * 6 + [_I] * 6 + [_P],
    "stockham_fft_sublane_real": [_P] * 5 + [_I] * 5 + [_P],
    "stockham_ifft_sublane_real_out": [_P] * 5 + [_I] * 5 + [_P],
    "stockham_sublane_conv": [_P] * 7 + [_I] * 5 + [_P],
    "stockham_fft_mid": [_P] * 6 + [_I] * 7 + [_P],
}


@functools.lru_cache(maxsize=None)
def build_library():
    """Compile ``csrc/stockham.cu`` (once per source content) and load it.
    Raises with the compiler's output if the build fails."""
    lib = build("stockham.cu")
    for name, argtypes in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def tile_width(n, inner):
    """Columns per block: the widest power of two up to 32 (128-byte row
    segments of each f32 plane) and up to the column count (rounded up)
    whose tile fits the core, n W <= ``fft_plan.MAX_TILE``
    (``fft_plan.tile_width``).  Raises ``ValueError`` for an axis longer
    than ``fft_plan.MAX_AXIS``."""
    return fft_plan.tile_width(n, inner, 32, 4)


def _check(name, ts, ndim, axis):
    """What the kernel takes: f32, one shape, contiguous, one device, a
    power-of-two transform axis that fits in shared memory.  Returns
    whether to launch the kernel (False for CPU tensors)."""
    x = ts[0]
    shape = tuple(x.shape)
    if x.ndim != ndim:
        raise ValueError(f"{name}: expects {ndim}-D input, got "
                         f"{tuple(x.shape)}")
    n = int(x.shape[axis])
    if n < 1 or n & (n - 1):
        raise ValueError(f"{name} needs a power-of-two axis {axis}, got {n}")
    for t in ts:
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: float32 only, got {t.dtype}")
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"{name}: inputs must be {shape} on {x.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    tile_width(n, int(x.shape[-1]))
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if any(t.requires_grad for t in ts):
        raise ValueError(f"{name}: inputs that require grad are not "
                         "supported (the kernel has no gradient)")
    return True


def _launch(key, entry, ins, n_out, dims, inverse=None):
    """One launch on the current stream of the inputs' device; ``dims``
    are the C entry's sizes, the last of them the contiguous one."""
    x = ins[0]
    n = int(x.shape[0] if x.ndim == 2 else x.shape[1])
    outs = [torch.empty_like(x) for _ in range(n_out)]
    plan, nst, tw = fft_plan.device_plan(n, torch.float32, x.device)
    args = [t.data_ptr() for t in ins + outs]
    args += [tw.data_ptr(), plan.data_ptr(), nst, tw.shape[0], *dims,
             tile_width(n, dims[-1])]
    if inverse is not None:
        args.append(int(inverse))
    fn = getattr(build_library(), entry)
    with torch.cuda.device(x.device):
        args.append(torch.cuda.current_stream(x.device).cuda_stream)
        err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA launch failed (error {err})")
    launches[key] += 1
    return outs


# -- plain torch.fft versions -------------------------------------------


def _split(z):
    return z.real.contiguous(), z.imag.contiguous()


def fft_sublane_reference(xr, xi):
    return _split(torch.fft.fft(torch.complex(xr, xi), dim=0))


def ifft_sublane_reference(xr, xi):
    return _split(torch.fft.ifft(torch.complex(xr, xi), dim=0))


def fft_sublane_real_reference(xr):
    return _split(torch.fft.fft(xr, dim=0))


def ifft_sublane_real_out_reference(xr, xi):
    return torch.fft.ifft(torch.complex(xr, xi), dim=0).real.contiguous()


def sublane_conv_reference(xr, xi, k):
    z = torch.fft.fft(torch.complex(xr, xi), dim=0)
    return _split(torch.fft.ifft(k * z, dim=0))


def fft_mid_reference(xr, xi):
    return _split(torch.fft.fft(torch.complex(xr, xi), dim=1))


def ifft_mid_reference(xr, xi):
    return _split(torch.fft.ifft(torch.complex(xr, xi), dim=1))


def conv3_bfly_reference(x, k_t):
    K = k_t.permute(2, 1, 0)
    return torch.fft.ifftn(K * torch.fft.fftn(x)).real.contiguous()


# -- the kernel's entry points ------------------------------------------


def _sublane_fft(name, xr, xi, inverse):
    if not _check(name, (xr, xi), 2, 0):
        ref = ifft_sublane_reference if inverse else fft_sublane_reference
        return ref(xr, xi)
    n, B = xr.shape
    return tuple(_launch("fft_sublane", "stockham_fft_sublane", [xr, xi], 2,
                         [n, B], inverse))


def fft_sublane(xr, xi):
    """Forward DFT along axis 0 of an (n, B) f32 batch (n a power of 2),
    complex as (re, im); matches ``torch.fft.fft(xr + 1j xi, dim=0)``."""
    return _sublane_fft("fft_sublane", xr, xi, False)


def ifft_sublane(xr, xi):
    """Inverse (1/n-normalised) DFT along axis 0."""
    return _sublane_fft("ifft_sublane", xr, xi, True)


def fft_sublane_real(xr):
    """Forward DFT along axis 0 of a REAL (n, B) f32 batch (full
    spectrum; the imaginary input is made as zeros in the kernel)."""
    if not _check("fft_sublane_real", (xr,), 2, 0):
        return fft_sublane_real_reference(xr)
    n, B = xr.shape
    return tuple(_launch("fft_sublane_real", "stockham_fft_sublane_real",
                         [xr], 2, [n, B]))


def ifft_sublane_real_out(xr, xi):
    """Inverse DFT along axis 0 returning only the real part."""
    if not _check("ifft_sublane_real_out", (xr, xi), 2, 0):
        return ifft_sublane_real_out_reference(xr, xi)
    n, B = xr.shape
    return _launch("ifft_sublane_real_out", "stockham_ifft_sublane_real_out",
                   [xr, xi], 1, [n, B])[0]


def sublane_conv(xr, xi, k):
    """Fused ``ifft(k * fft(x))`` along axis 0 with a REAL (n, B) kernel
    ``k``, one residency of each tile."""
    if not _check("sublane_conv", (xr, xi, k), 2, 0):
        return sublane_conv_reference(xr, xi, k)
    n, B = xr.shape
    return tuple(_launch("sublane_conv", "stockham_sublane_conv",
                         [xr, xi, k], 2, [n, B]))


def _mid_fft(name, xr, xi, inverse):
    if not _check(name, (xr, xi), 3, 1):
        ref = ifft_mid_reference if inverse else fft_mid_reference
        return ref(xr, xi)
    return tuple(_launch("fft_mid", "stockham_fft_mid", [xr, xi], 2,
                         list(xr.shape), inverse))


def fft_mid(xr, xi):
    """Forward DFT along axis 1 of an (n0, n1, n2) f32 (re, im) pair, no
    transpose; matches ``torch.fft.fft(xr + 1j xi, dim=1)``."""
    return _mid_fft("fft_mid", xr, xi, False)


def ifft_mid(xr, xi):
    """Inverse (1/n1-normalised) DFT along axis 1."""
    return _mid_fft("ifft_mid", xr, xi, True)


def conv3_bfly(x, k_t):
    """Composed 3-D spectral convolution ``ifftn(K * fftn(x)).real`` for a
    REAL f32 cube ``x`` and a real full-spectrum kernel given in (z, y, x)
    layout, ``k_t = K.permute(2, 1, 0)``, as the JAX module composes it:
    forward x (real input), forward y (middle axis), a transpose that
    brings z to axis 0, the fused z step with the kernel multiply,
    the transpose back, inverse y, inverse x keeping the real part.  The
    result is real only for a Hermitian-even K."""
    n0, n1, n2 = x.shape
    if tuple(k_t.shape) != (n2, n1, n0):
        raise ValueError(f"conv3_bfly: k_t must be {(n2, n1, n0)}, got "
                         f"{tuple(k_t.shape)}")
    xr, xi = fft_sublane_real(x.reshape(n0, n1 * n2))
    xr, xi = fft_mid(xr.reshape(n0, n1, n2), xi.reshape(n0, n1, n2))
    xr = xr.permute(2, 1, 0).contiguous().reshape(n2, n1 * n0)
    xi = xi.permute(2, 1, 0).contiguous().reshape(n2, n1 * n0)
    xr, xi = sublane_conv(xr, xi, k_t.reshape(n2, n1 * n0))
    xr = xr.reshape(n2, n1, n0).permute(2, 1, 0).contiguous()
    xi = xi.reshape(n2, n1, n0).permute(2, 1, 0).contiguous()
    xr, xi = ifft_mid(xr, xi)
    y = ifft_sublane_real_out(xr.reshape(n0, n1 * n2),
                              xi.reshape(n0, n1 * n2))
    return y.reshape(n0, n1, n2)
