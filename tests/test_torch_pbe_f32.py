"""The fused PBE potential in f32 at densities near the f32 floor.

Where chi crosses zero, the f32 chi parameterisation floors the density at
1e-10 of its mean (~3e-12 bohr^-3).  Next to a finite gradient there, PBE's
reduced gradients t2 and s2 overflow and the JAX package's fused potential
turns into inf / inf = NaN; the divergence term then spreads it over the
whole grid.  The port takes the vanishing-density limit 0 at those points:
its potential stays finite and agrees with the f64 evaluation, within f32
rounding, wherever the density is not negligible."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from professad_tpu.models import PerdewBurkeErnzerhof as jPBE
from professad_tpu.models import potentials as jpot
from professad_tpu_torch.models import PerdewBurkeErnzerhof as tPBE
from professad_tpu_torch.models import potentials as tpot

N, L, N_ELEC = 32, 7.653, 12.0


def _density(amp, off):
    """chi = amp sin(2 pi x / L) + smooth background, shifted so that one
    grid point holds chi = off; the density through the f32 floor."""
    x = np.arange(N) * L / N
    X, Y, _ = np.meshgrid(x, x, x, indexing="ij")
    chi = amp * np.sin(2 * np.pi * (X - x[8]) / L) \
        + 0.01 * np.cos(2 * np.pi * Y / L)
    chi = chi - chi[8, 0, 0] + off
    vol = L ** 3
    den = chi * chi * N_ELEC / (np.mean(chi * chi) * vol)
    c = 1e-10 * N_ELEC / vol
    return (den + c) * (N_ELEC / (N_ELEC + c * vol))


@pytest.mark.parametrize("amp, off", [(0.3, 5e-6), (0.3, -5e-6),
                                      (0.2, 5e-6), (0.16, 5e-6)])
def test_pbe_potential_finite_near_floor(amp, off):
    den = _density(amp, off)
    box = L * np.eye(3)
    _, pj = jpot.value_and_potential(
        [jPBE], jnp.asarray(box, jnp.float32), jnp.asarray(den, jnp.float32),
        jnp.zeros(den.shape, jnp.float32))
    # the reference's f32 potential is not finite here
    assert not np.all(np.isfinite(np.asarray(pj)))

    def port(dt):
        return tpot.value_and_potential(
            [tPBE], torch.tensor(box, dtype=dt), torch.tensor(den, dtype=dt),
            torch.zeros(den.shape, dtype=dt))
    E32, p32 = port(torch.float32)
    E64, p64 = port(torch.float64)
    _, pj64 = jpot.value_and_potential(
        [jPBE], jnp.asarray(box), jnp.asarray(den), jnp.zeros(den.shape))
    assert np.allclose(p64.numpy(), np.asarray(pj64), rtol=1e-10, atol=1e-12)
    assert torch.all(torch.isfinite(p32))
    assert abs(float(E32) - float(E64)) < 1e-6
    keep = torch.tensor(den > 1e-6)
    assert float(torch.max(torch.abs(p32.double() - p64)[keep])) < 3e-5
