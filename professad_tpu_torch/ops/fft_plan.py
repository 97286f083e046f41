"""Stage plans and tile shapes of the shared-memory Stockham FFT core
(``csrc/fft_core.cuh``), computed on the host.

An axis of length n is factorised into radix-4 stages, at most one radix-2
stage, radix-3 and radix-5 stages, and one generic stage for every other
prime factor.  Stage ``(R, ns)`` (``ns`` the product of the earlier radices)
takes butterfly ``j`` in ``[0, n / R)``, ``k = j mod ns``, reads
``x[j + r n / R] * exp(-2 pi i r k / (ns R))`` and writes its R-point DFT to
``y[(j - k) R + k + q ns]``; the output is in natural order.  The twiddles are
computed here in double, from exactly reduced integer angles, and cast to
the working type once.  The table of a butterfly stage (``BUTTERFLIES``)
holds ``ns (R - 1)`` values at ``k (R - 1) + r - 1``; a generic stage's
holds the ``ns R`` roots
``exp(-2 pi i t / (ns R))``, since it sums every output directly.

The tile a block transforms is n rows x W columns; a thread holds at most
``PER_THREAD`` complex values during a stage and a block has at most
``MAX_THREADS`` threads, so ``n W <= MAX_TILE``.  The longest axis is
``MAX_AXIS``: the wrappers raise beyond it, for CPU tensors too.
"""

import functools

import numpy as np
import torch

__all__ = ["MAX_AXIS", "MAX_TILE", "radices", "stages", "device_plan",
           "tile_width"]

PER_THREAD = 8         # fftcore::kPerThread
MAX_THREADS = 512      # fftcore::kMaxThreads
MAX_TILE = PER_THREAD * MAX_THREADS
MAX_AXIS = 4096
BUTTERFLIES = (2, 3, 4, 5)   # radices with a butterfly of their own
_SMEM_MAX = 232448     # the most shared memory one block may use on Hopper


def radices(n):
    """The stage radices of an axis of length n, in the order they run."""
    if n < 1:
        raise ValueError(f"FFT length must be positive, got {n}")
    out = []
    while n % 4 == 0:
        out.append(4)
        n //= 4
    if n % 2 == 0:
        out.append(2)
        n //= 2
    p = 3
    while n > 1:
        while n % p == 0:
            out.append(p)
            n //= p
        p += 2
    return out


@functools.lru_cache(maxsize=None)
def stages(n):
    """``((R, ns, offset), ...)`` and the complex128 twiddles of all stages
    of an axis of length n, concatenated at those offsets."""
    plan, tables, off, ns = [], [], 0, 1
    for R in radices(n):
        L = ns * R
        if R in BUTTERFLIES:
            k, r = np.meshgrid(np.arange(ns), np.arange(1, R), indexing="ij")
            t = (k * r).ravel()
        else:
            t = np.arange(L)
        tables.append(np.exp(-2j * np.pi * (t % L) / L))
        plan.append((R, ns, off))
        off += t.size
        ns = L
    tw = np.concatenate(tables) if tables else np.zeros(0, np.complex128)
    return tuple(plan), tw


@functools.lru_cache(maxsize=None)
def device_plan(n, dtype, device):
    """The plan as a flat int32 tensor of (R, ns, offset) triples, its stage
    count and the (L, 2) twiddle table in ``dtype``, on ``device``."""
    plan, tw = stages(n)
    p = torch.tensor([v for st in plan for v in st], dtype=torch.int32,
                     device=device)
    t = torch.as_tensor(np.stack([tw.real, tw.imag], axis=1), dtype=dtype,
                        device=device).contiguous()
    return p, len(plan), t


def tile_width(n, inner, width, itemsize):
    """Columns per tile for an axis of n and ``inner`` columns: the widest
    power of two up to ``width`` and up to the column count (rounded up)
    with ``n W <= MAX_TILE`` and the padded tile of complex values of
    ``itemsize``-byte parts within a block's shared memory.  Raises
    ``ValueError`` for an axis longer than ``MAX_AXIS``."""
    if n > MAX_AXIS:
        raise ValueError(f"FFT: an axis of {n} does not fit in shared memory "
                         f"(at most {MAX_AXIS})")
    w = min(width, 1 << max(0, int(inner - 1).bit_length()))
    while w > 1 and (n * w > MAX_TILE
                     or n * (w + 1) * 2 * itemsize > _SMEM_MAX):
        w //= 2
    return w
