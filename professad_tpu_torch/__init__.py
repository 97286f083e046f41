"""PyTorch/CUDA port of PROFESS-AD-TPU (orbital-free DFT), for one NVIDIA
H100.

The port grows slice by slice beside the JAX package ``professad_tpu``,
which stays the reference.  Ported so far: the ``System`` setup, the
WT+PBE term set with its fused analytic potentials, the density
optimizers (host-loop and whole-optimization L-BFGS and TPGD, autograd or
fused analytic chi gradient, the exact uniform-density preconditioner),
the convergence diagnostics, forces and stress.  Both Pallas kernel files
of the JAX package have hand-written CUDA counterparts: the fused spectral
convolution (``ops/spectral_conv.py``, ``csrc/spectral_conv.cu``), which
the density path runs on CUDA tensors, and the radix-2 Stockham FFTs
(``ops/vpufft.py``, ``csrc/stockham.cu``); on CPU tensors each runs its
``torch.fft`` reference.

Every tensor is created with an explicit device and dtype; nothing relies
on ``torch.get_default_dtype()``.  The entry points run on ``cuda:0``
unless given ``device="cpu"``.
"""

from .ops.grid import wavevecs, grad_dot_grad, laplacian
from .ops.interp import interpolate
from .system import System
from .convert import system_state_from_jax

__all__ = ["System", "system_state_from_jax", "wavevecs", "grad_dot_grad",
           "laplacian", "interpolate"]

__version__ = "0.1.0"
