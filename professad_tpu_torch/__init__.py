"""PyTorch/CUDA port of PROFESS-AD-TPU (orbital-free DFT), for one NVIDIA
H100.

The port grows slice by slice beside the JAX package ``professad_tpu``,
which stays the reference.  Ported so far: the single-device ``System``
(setup, setters and getters, checkpoints), the whole functional library
(the WT family, WGC99, Foley-Madden, KGAP, Huang-Carter and revHC, MGP,
XWM, the local, GGA and Yukawa-GGA kinetic functionals, the neural
functional with its training step, the LDA and PBE exchange-correlation
functionals) with their fused analytic potentials, the field-dependent
(xi-ladder) convolution, the density optimizers (host-loop and
whole-optimization L-BFGS and TPGD; autograd, fused analytic or
user-supplied chi gradient; the exact uniform-density preconditioner), the
convergence diagnostics, forces and stress, the geometry relaxations with
their host optimizers, the second derivatives through the ground state,
the EOS scan (serial, and lane-batched under ``torch.func.vmap``) with its
fit, the crystal cell generators, the elastic averages, linear response
G^-1(eta), stress and pressure of a functional, the profiling hooks and
the reference's drop-in module names (``functionals``,
``functional_tools``, ``ion_utils``, ``crystal_tools``,
``elastic_tools``), and the multi-device runs on ``torch.distributed``
(``parallel``: one process per device, NCCL on the cards and gloo on the
CPU; pencil FFTs and every mesh path of ``System``).
Both Pallas kernel files of the JAX package have hand-written CUDA
counterparts: the fused spectral convolution
(``ops/spectral_conv.py``, ``csrc/spectral_conv.cu``), which the density
path runs on CUDA tensors, and the radix-2 Stockham FFTs
(``ops/vpufft.py``, ``csrc/stockham.cu``); on CPU tensors each runs its
``torch.fft`` reference.

Every tensor is created with an explicit device and dtype; nothing relies
on ``torch.get_default_dtype()``.  The entry points run on ``cuda:0``
unless given ``device="cpu"``.
"""

from .ops.grid import (wavevecs, grad_i, grad_dot_grad, laplacian,
                       reduced_gradient, reduced_gradient_squared,
                       reduced_laplacian)
from .ops.interp import interpolate, interpolate_kernel
from .ops.fieldconv import (field_dependent_convolution,
                            field_dependent_convolution_naive, xi_ladder)
from .ops.autodiff import (get_functional_derivative, get_inv_G, get_stress,
                           get_pressure)
from .system import System
from .utils.crystal import get_cell
from .utils.elastic import (fit_eos, voigt_moduli, reuss_moduli,
                            shear_average, poissons_ratio, youngs_modulus)
from .utils.profiling import trace, annotate, StepTimer
from .convert import (system_state_from_jax, functional_params_from_jax,
                      functional_state_from_jax)

__all__ = ["System", "system_state_from_jax", "functional_params_from_jax",
           "functional_state_from_jax",
           "wavevecs", "grad_i", "grad_dot_grad", "laplacian",
           "reduced_gradient", "reduced_gradient_squared",
           "reduced_laplacian", "interpolate", "interpolate_kernel",
           "field_dependent_convolution", "field_dependent_convolution_naive",
           "xi_ladder", "get_functional_derivative", "get_inv_G",
           "get_stress", "get_pressure", "get_cell", "fit_eos",
           "voigt_moduli", "reuss_moduli", "shear_average",
           "poissons_ratio", "youngs_modulus", "trace", "annotate",
           "StepTimer"]

__version__ = "0.1.0"
