"""The port's density-optimization example (examples/
torch_density_optimization.py) on the CPU at 500 eV: its host-loop energy
against the JAX package's ``System`` on the same cell and grid within 1e-8
eV, the other three paths within 1e-6 eV of it; and every new example
refuses to run without a card unless it is given a device.

The geometry and training examples are in ``test_torch_examples_geometry.py``
and ``test_torch_examples_training.py``
(each file stays under half a minute alone).
"""

import importlib
import os
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from professad_tpu.system import System as JSystem
from professad_tpu.models import (IonIon, IonElectron, Hartree, WangTeter,
                                  PerdewBurkeErnzerhof)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
sys.path.insert(0, EXAMPLES)
NAMES = ("torch_density_optimization", "torch_geometry_optimization",
         "torch_parameterized_functionals")


@pytest.fixture(scope="module")
def density_run():
    ex = importlib.import_module("torch_density_optimization")
    return ex, ex.main(device="cpu", ecut=500.0, verbose=False)


def test_density_example_host_loop_matches_jax(density_run):
    ex, out = density_run
    assert out["shape"] == (13, 13, 13)
    js = JSystem(jnp.asarray(ex.BOX), out["shape"],
                 [["Al", ex.POT, jnp.zeros((1, 3))]],
                 [IonIon, IonElectron, Hartree, WangTeter,
                  PerdewBurkeErnzerhof], units="a", coord_type="fractional")
    js.optimize_density(ntol=1e-7)
    assert out["host"]["conv"]
    assert abs(out["host"]["E"] - js.energy("eV")) < 1e-8


@pytest.mark.parametrize("path", ["jit_loop", "tpgd", "analytic"])
def test_density_example_paths_agree(density_run, path):
    _, out = density_run
    assert out[path]["conv"]
    assert abs(out[path]["E"] - out["host"]["E"]) < 1e-6
    assert out["euler"] < 1e-3 and np.isfinite(out["mu"])
    # CPU tensors run the kernel's plain version: nothing is launched
    assert out[path]["launches"] == 0


@pytest.mark.parametrize("name", NAMES)
def test_example_raises_without_a_card(name, monkeypatch):
    """``main()`` means the first CUDA card; without one it raises."""
    ex = importlib.import_module(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ex.main()
