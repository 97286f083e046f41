"""Huang-Carter through ``optimize_density(jit_loop=True, analytic=True)``
in both packages, f64 on the CPU: ``tests/test_potentials.py``'s
end-to-end case (primitive fcc Al, 12^3, HC (0.45, 0.51, 1.2), IonIon +
IonElectron + Hartree + HC + PBE), the JAX package run once per module on
the same system and call.

Most of this file's time is the JAX package's side: its System's eager
set-up and the XLA compiles of its preconditioner and TPGD loop.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from professad_tpu import models as jm
from professad_tpu.system import System as JSystem
from professad_tpu_torch import System
from professad_tpu_torch import models as tm
from paths import pot

HC_ARGS = (0.45, 0.51, 1.2)
PRIM = 4.05 * np.array([[0.5, 0.5, 0.0], [0.0, 0.5, 0.5], [0.5, 0.0, 0.5]])
KW = dict(ntol=1e-9, jit_loop=True, precondition=True, n_step_size=1.0,
          n_method="TPGD", skip_iters=2, analytic=True)


def _terms(models):
    return [models.IonIon, models.IonElectron, models.Hartree,
            models.HuangCarter(HC_ARGS).forward, models.PerdewBurkeErnzerhof]


@pytest.fixture(scope="module")
def jax_hc_8_steps():
    """The JAX package's stored energy (eV) after the call with
    n_maxiter=8.  Past its 8th step the run amplifies rounding 30-40 fold a
    step (the ladder is prepared from the start density, and the converged
    density's xi runs far above its top rung), so the packages are held
    step for step up to there."""
    js = JSystem(jnp.asarray(PRIM), (12, 12, 12),
                 [["Al", pot("al.gga.recpot"), jnp.zeros((1, 3))]],
                 _terms(jm), units="a", coord_type="fractional")
    js.optimize_density(n_maxiter=8, **KW)
    return js.energy("eV")


def test_hc_optimize_density_end_to_end(jax_hc_8_steps):
    """8 steps of the port against the JAX package's, 1e-8 eV."""
    s = System(PRIM, (12, 12, 12),
               [["Al", pot("al.gga.recpot"), np.zeros((1, 3))]],
               _terms(tm), units="a", coord_type="fractional", device="cpu")
    assert s.optimize_density(n_maxiter=8, **KW) == (8, False)
    assert abs(s.energy("eV") - jax_hc_8_steps) < 1e-8
