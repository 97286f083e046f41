"""Carry state and functional parameters across from the JAX package.

``system_state_from_jax`` takes the dict that ``professad_tpu``'s
``System.state_dict()`` returns (numpy arrays and plain Python values) and
returns it with the arrays as tensors on a chosen device and dtype, ready
for this package's ``System.load_state_dict``.
``functional_params_from_jax`` does the same for a trainable functional's
``params`` dict, for ``KineticFunctional.load_params``, and
``functional_state_from_jax`` for everything a JAX functional carries
(parameters, its prepared xi ladder, its kernel tables and hoisted kernel
slabs), for ``KineticFunctional.load_functional_state``.  No JAX import is
needed: the input is read through ``np.asarray``.
"""

import numpy as np
import torch

from .utils.device import resolve_device

__all__ = ["system_state_from_jax", "functional_params_from_jax",
           "functional_state_from_jax"]

_ARRAY_KEYS = ("box_vecs", "frac_ion_coords", "den", "v_ext")


def system_state_from_jax(state, device=None, dtype=torch.float64):
    """Convert a JAX ``System.state_dict()`` to this package's tensors.

    ``device=None`` means ``cuda:0`` and raises without a CUDA device;
    pass ``device="cpu"`` for the CPU."""
    missing = [k for k in _ARRAY_KEYS + ("N_elec", "shape", "ions")
               if k not in state]
    if missing:
        raise KeyError(f"state dict lacks {missing}")
    device = resolve_device(device)
    out = {k: torch.tensor(np.asarray(state[k]), dtype=dtype, device=device)
           for k in _ARRAY_KEYS}
    out["N_elec"] = state["N_elec"]
    out["shape"] = tuple(int(s) for s in state["shape"])
    out["ions"] = [tuple(ion) for ion in state["ions"]]
    return out


def functional_params_from_jax(params):
    """A JAX functional's ``params`` (name -> array) as float64 CPU
    tensors, for ``KineticFunctional.load_params``, which copies them to
    the module's device.  Callables such as a WT-style stabilizer ``f`` are
    not parameters and are not carried: construct the port's functional
    with the torch counterpart."""
    return {k: torch.tensor(np.asarray(v), dtype=torch.float64)
            for k, v in params.items()}


def functional_state_from_jax(owner, device=None):
    """The state of a JAX functional (an instance of one of its
    ``KineticFunctional`` classes) as this package's tensors: ``params``,
    the ``xi_sparse`` ladder its ``prepare`` cached (a numpy array, as
    here, or None), its kernel table ``kernel`` (HC's ODE solution, MGP's
    line integral) and the per-cell arrays ``_aux`` its ``prepare``
    hoisted (HC's ladder and slabs, MGP's k-space kernel), each None
    where the functional has none.  With it both packages evaluate the
    same ladder and the same tables.

    ``device=None`` means ``cuda:0``; pass ``device="cpu"`` for the CPU."""
    device = resolve_device(device)

    def tensor(a):
        return torch.tensor(np.asarray(a), dtype=torch.float64,
                            device=device)
    ladder = getattr(owner, "xi_sparse", None)
    kernel = getattr(owner, "kernel", None)
    aux = getattr(owner, "_aux", None)
    return {
        "params": {k: tensor(v) for k, v in owner.params.items()},
        "xi_sparse": None if ladder is None else np.array(ladder,
                                                          np.float64),
        "kernel": None if kernel is None else tuple(tensor(t)
                                                    for t in kernel),
        "aux": None if aux is None else {k: tensor(v)
                                         for k, v in aux.items()},
    }
