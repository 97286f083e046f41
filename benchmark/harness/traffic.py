"""The one generator of requests: it reads a traffic mix's parameters and
makes the requests of a run from ``--seed``, on the host.

Kinds of request (``"request"`` in the mix):

- ``ground_state``: the ions of the configuration's ideal supercell
  displaced by a Cartesian Gaussian of ``sigma_A`` per component, either
  drawn anew for each request (``"process": "iid"``) or following the
  AR(1) process u_k = rho u_(k-1) + sqrt(1 - rho^2) sigma xi_k from a
  stationary u_0 (``"process": "ar1"``); ``"start"`` says whether the
  density starts uniform or from the last ground state;
- ``eos_fit``: a c/a drawn uniformly from ``c_over_a``, at the
  configuration's volume per atom, with the scan's ``f`` and ``N``.

``--seed`` draws every request.  Request k of a seed is the same whatever
the run's length: a seed gives one sequence, and a run serves as much of
it as its window holds.
"""

import numpy as np

from .spec import ideal_cell


class Requests:
    def __init__(self, mix, config, seed):
        self.mix = mix
        self.config = config
        self.kind = mix["request"]
        if self.kind not in ("ground_state", "eos_fit"):
            raise ValueError(f"unknown request kind {self.kind!r}")
        self.rng = np.random.default_rng([int(seed) % (1 << 63), 1])
        self.box, self.frac0 = ideal_cell(config)
        if self.kind == "ground_state":
            disp = mix["displacement"]
            self.sigma = float(disp["sigma_A"])
            self.rho = float(disp.get("rho", 0.0)) \
                if disp["process"] == "ar1" else None
            if disp["process"] not in ("iid", "ar1"):
                raise ValueError(f"unknown process {disp['process']!r}")
            self.u = self._noise()          # u_0, stationary

    def _noise(self):
        return self.sigma * self.rng.standard_normal(self.frac0.shape)

    def initial(self):
        """The warm trajectory's start (``ar1``): its Cartesian ions [A]."""
        return self._positions(self.u)

    def _positions(self, u):
        cart = self.frac0 @ self.box + u
        frac = cart @ np.linalg.inv(self.box)
        return (frac - np.floor(frac)) @ self.box

    def next(self):
        if self.kind == "eos_fit":
            lo, hi = self.mix["c_over_a"]
            return {"c_over_a": float(self.rng.uniform(lo, hi))}
        if self.rho is None:
            self.u = self._noise()
        else:
            self.u = (self.rho * self.u
                      + np.sqrt(1.0 - self.rho ** 2) * self._noise())
        return {"cart_A": self._positions(self.u)}
