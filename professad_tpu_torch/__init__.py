"""PyTorch/CUDA port of PROFESS-AD-TPU (orbital-free DFT), for one NVIDIA
H100.

The port grows slice by slice beside the JAX package ``professad_tpu``,
which stays the reference.  This slice is the density-optimization main
path: the ``System`` setup, the WT+PBE term set with its fused analytic
potentials, the exact uniform-density preconditioner and preconditioned
TPGD.  The dedicated spectral convolutions run through a hand-written CUDA
kernel (``ops/spectral_conv.py``, ``csrc/spectral_conv.cu``) on CUDA
tensors and through its ``torch.fft`` reference on CPU tensors.

Every tensor is created with an explicit device and dtype; nothing relies
on ``torch.get_default_dtype()``.
"""

from .ops.grid import wavevecs, grad_dot_grad, laplacian
from .ops.interp import interpolate
from .system import System
from .convert import system_state_from_jax

__all__ = ["System", "system_state_from_jax", "wavevecs", "grad_dot_grad",
           "laplacian", "interpolate"]

__version__ = "0.1.0"
