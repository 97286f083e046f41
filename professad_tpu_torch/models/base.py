"""Trainable kinetic-functional template.

PyTorch port of ``professad_tpu/models/base.py::KineticFunctional``.  A
functional is an ``nn.Module`` whose parameters are float64
``nn.Parameter``s in the ``ParameterDict`` ``self.params``:

* ``functional.apply(params, box_vecs, den)`` is the energy as a function
  of an explicit parameter mapping (it shadows ``nn.Module.apply(fn)``, as
  the JAX package's pure ``apply`` does);
* ``functional(box_vecs, den)`` / ``functional.forward(...)`` use the
  module's own parameters, for use as an energy term.

Move the module to the system's device (``.to(device)`` or
``set_device``) before a run on the card.

Training: ``update_params(loss_fn)`` takes one Rprop step (learning rate
0.1) on ``loss_fn(params)``.  The rule is the JAX package's optimizer,
``optax.rprop(0.1)`` as installed (optax 0.2.6), with its one-step lag:
each step applies the update computed at the step before, so the first
step leaves the parameters where they are (``torch.optim.Rprop`` does not
lag).  The state mirrors optax's, ``((step_sizes, prev_updates), ())``
with one tensor per parameter.  ``save`` / ``load`` pickle the JAX
package's dict (parameters and optimizer state as numpy arrays, the state
as plain tuples); ``load`` also reads a JAX checkpoint, whose optax state
needs optax to unpickle.
"""

import pickle

import numpy as np
import torch
from torch import nn

__all__ = ["KineticFunctional"]

# optax.rprop(learning_rate=0.1) with optax's default factors and bounds
_RPROP_LR = 0.1
_ETA_MINUS, _ETA_PLUS = 0.5, 1.2
_MIN_STEP, _MAX_STEP = 1e-6, 50.0


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
        """Create the float64 parameters (numbers or arrays) and the
        optimizer state."""
        for name, value in values.items():
            self.params[name] = nn.Parameter(
                torch.tensor(np.asarray(value, dtype=np.float64)))
        self.initialize()

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

    def load_functional_state(self, state):
        """Take the state ``convert.functional_state_from_jax`` read from a
        JAX functional: the parameters, and the ladder, kernel table and
        hoisted slabs where the functional has them (moved to the
        parameters' device)."""
        self.load_params(state["params"])
        dev = next(iter(self.params.values())).device
        if state.get("xi_sparse") is not None:
            self.xi_sparse = np.array(state["xi_sparse"], np.float64)
        if state.get("kernel") is not None:
            self.kernel = tuple(t.to(dev) for t in state["kernel"])
        if state.get("aux") is not None:
            self._aux = {k: v.to(dev) for k, v in state["aux"].items()}

    # -- optimizer ----------------------------------------------------------
    def initialize(self):
        """Reset the optimizer state: every step size at the learning
        rate, no previous update."""
        with torch.no_grad():
            self.opt_state = (
                ({k: torch.full_like(p, _RPROP_LR)
                  for k, p in self.params.items()},
                 {k: torch.zeros_like(p) for k, p in self.params.items()}),
                ())

    def param_grad(self, requires_grad=True):
        """Switch the parameters' gradients on or off."""
        for p in self.params.values():
            p.requires_grad_(requires_grad)

    def set_device(self, device=None):
        """Move the parameters, the optimizer state, and what ``prepare``
        cached (kernel tables, hoisted slabs) to ``device``."""
        if device is None:
            return
        self.to(device)
        if getattr(self, "kernel", None) is not None:
            self.kernel = tuple(t.to(device) for t in self.kernel)
        if getattr(self, "_aux", None) is not None:
            self._aux = {k: v.to(device) for k, v in self._aux.items()}
        if self.opt_state is not None:
            (step, prev), rest = self.opt_state
            self.opt_state = (({k: v.to(device) for k, v in step.items()},
                               {k: v.to(device) for k, v in prev.items()}),
                              rest)

    def update_params(self, loss_fn):
        """One Rprop step on ``loss_fn(params) -> scalar``; returns the
        loss before the step."""
        names = list(self.params.keys())
        with torch.enable_grad():
            loss = loss_fn(self.params)
            grads = torch.autograd.grad(
                loss, [self.params[k] for k in names], allow_unused=True)
        (step, prev), rest = self.opt_state
        new_step, new_prev = {}, {}
        with torch.no_grad():
            for k, g in zip(names, grads):
                p = self.params[k]
                g = torch.zeros_like(p) if g is None else g
                sign = g * prev[k]
                grown = torch.where(sign > 0, step[k] * _ETA_PLUS,
                                    step[k] * _ETA_MINUS)
                new_step[k] = torch.where(
                    sign == 0, step[k],
                    torch.clamp(grown, _MIN_STEP, _MAX_STEP))
                new_prev[k] = torch.where(sign < 0, 0.0,
                                          new_step[k] * torch.sign(g))
                # the update applied now is the one computed a step ago
                p.sub_(torch.where(sign < 0, 0.0, prev[k]))
        self.opt_state = ((new_step, new_prev), rest)
        return loss.detach()

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
        """Pickle init_args, the parameters and the optimizer state as
        numpy arrays, and the training curves (the JAX package's
        layout)."""
        state = None
        if self.opt_state is not None:
            (step, prev), rest = self.opt_state
            state = (({k: v.detach().cpu().numpy() for k, v in step.items()},
                      {k: v.detach().cpu().numpy() for k, v in prev.items()}),
                     rest)
        blob = {
            "init_args": self.init_args,
            "params": {k: v.detach().cpu().numpy()
                       for k, v in self.params.items()},
            "opt_state": state,
            "training_curve": self.training_curve,
            "validation_curve": self.validation_curve,
        }
        with open(path, "wb") as fh:
            pickle.dump(blob, fh)

    @classmethod
    def load(cls, path):
        """Restore a functional saved by this package or the JAX one (a
        JAX checkpoint's optax state, ``(ScaleByRpropState(step_sizes,
        prev_updates), EmptyState())``, reads as the same tuples)."""
        with open(path, "rb") as fh:
            blob = pickle.load(fh)
        model = cls(blob["init_args"])
        model.load_params(blob["params"])
        if blob["opt_state"] is not None:
            step, prev = blob["opt_state"][0]
            p = model.params

            def tensors(d):
                return {k: torch.tensor(np.asarray(v), dtype=p[k].dtype,
                                        device=p[k].device)
                        for k, v in d.items()}
            model.opt_state = ((tensors(step), tensors(prev)), ())
        model.training_curve = blob["training_curve"]
        model.validation_curve = blob["validation_curve"]
        return model
