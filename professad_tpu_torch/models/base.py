"""Trainable kinetic-functional template.

PyTorch port of ``professad_tpu/models/base.py::KineticFunctional``.  A
functional is an ``nn.Module`` whose parameters are float64
``nn.Parameter``s in the ``ParameterDict`` ``self.params``:

* ``functional.apply(params, box_vecs, den)`` is the energy as a function
  of an explicit parameter mapping (it shadows ``nn.Module.apply(fn)``, as
  the JAX package's pure ``apply`` does);
* ``functional(box_vecs, den)`` / ``functional.forward(...)`` use the
  module's own parameters, for use as an energy term.

Move the module to the system's device (``.to(device)``) before a run on
the card.  The parameter optimizer (``initialize`` / ``update_params``,
optax Rprop in the JAX package) is not ported yet: ROADMAP A7.
``save`` / ``load`` pickle the same dict as the JAX package (parameters as
numpy arrays); a JAX checkpoint's optimizer state is optax's, and
unpickling it needs optax.
"""

import pickle

import numpy as np
import torch
from torch import nn

__all__ = ["KineticFunctional"]


class KineticFunctional(nn.Module):
    """Base class for kinetic functionals with tunable parameters.

    Subclasses call ``_init_params({name: value})`` in ``__init__`` and
    implement ``apply(params, box_vecs, den)``."""

    def __init__(self, init_args=None):
        super().__init__()
        self.init_args = init_args
        self.params = nn.ParameterDict()
        self.training_curve, self.validation_curve = [], []
        self.opt_state = None

    def _init_params(self, values):
        for name, value in values.items():
            self.params[name] = nn.Parameter(
                torch.tensor(float(value), dtype=torch.float64))

    def load_params(self, params):
        """Copy values (tensors, numpy arrays or numbers, e.g. from
        ``convert.functional_params_from_jax``) into the parameters, which
        keep their dtype and device."""
        unknown = set(params) - set(self.params.keys())
        if unknown:
            raise KeyError(f"{type(self).__name__} has no parameters "
                           f"{sorted(unknown)}")
        with torch.no_grad():
            for name, value in params.items():
                p = self.params[name]
                p.copy_(torch.as_tensor(np.asarray(value), dtype=p.dtype))

    # -- forward ----------------------------------------------------------
    def apply(self, params, box_vecs, den):
        raise NotImplementedError

    def forward(self, box_vecs, den):
        return self.apply(self.params, box_vecs, den)

    # -- training helpers ---------------------------------------------------
    def grid_error(self, target, prediction, norm=False):
        """Mean squared error on a grid; ``norm`` divides by the squared
        range of the target (1 for an all-zero target)."""
        err = torch.mean((target - prediction) ** 2)
        if norm:
            rng = torch.where(torch.all(target == 0),
                              torch.ones_like(err),
                              (torch.max(target) - torch.min(target)) ** 2)
            return err / rng
        return err

    def scalar_error(self, target, prediction):
        """Relative squared scalar error (absolute where the target is 0)."""
        target = torch.as_tensor(target)
        norm = torch.where(target == 0, torch.ones_like(target),
                           target * target)
        return (target - prediction) ** 2 / norm

    # -- checkpointing -------------------------------------------------------
    def save(self, path):
        """Pickle init_args, the parameters as numpy arrays and the
        training curves (the JAX package's layout)."""
        blob = {
            "init_args": self.init_args,
            "params": {k: v.detach().cpu().numpy()
                       for k, v in self.params.items()},
            "opt_state": self.opt_state,
            "training_curve": self.training_curve,
            "validation_curve": self.validation_curve,
        }
        with open(path, "wb") as fh:
            pickle.dump(blob, fh)

    @classmethod
    def load(cls, path):
        """Restore a functional saved by this package or the JAX one."""
        with open(path, "rb") as fh:
            blob = pickle.load(fh)
        model = cls(blob["init_args"])
        model.load_params(blob["params"])
        model.opt_state = blob["opt_state"]
        model.training_curve = blob["training_curve"]
        model.validation_curve = blob["validation_curve"]
        return model
