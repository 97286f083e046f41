"""The port's public surface (professad_tpu_torch): every name the JAX
package, its ``utils`` and its five drop-in modules export, the reference's
basic tutorial through the drop-in imports, the ``requires_grad=``
arguments, the profiling hooks, ``interpolate_recpot``, ``set_device``,
and that importing the port pulls in no JAX."""

import importlib
import os
import subprocess
import sys
import types
import warnings

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from paths import pot

COMPAT = ("functionals", "functional_tools", "ion_utils", "crystal_tools",
          "elastic_tools")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _public(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in dir(mod) if not n.startswith("_")
                 and not isinstance(getattr(mod, n), types.ModuleType)]
    return set(names)


@pytest.mark.parametrize("module", ("", ".utils", ".parallel") + tuple(
    "." + m for m in COMPAT))
def test_every_jax_name_resolves(module):
    """Every public name of professad_tpu<module> resolves in
    professad_tpu_torch<module> (``__version__`` aside)."""
    jmod = importlib.import_module("professad_tpu" + module)
    tmod = importlib.import_module("professad_tpu_torch" + module)
    missing = sorted(n for n in _public(jmod) - {"__version__"}
                     if not hasattr(tmod, n))
    assert not missing, missing


def test_reference_surface_importable():
    """tests/test_migration_surface.py's REFERENCE_SURFACE, from the
    port's drop-in modules."""
    from test_migration_surface import REFERENCE_SURFACE
    for mod, names in REFERENCE_SURFACE.items():
        m = importlib.import_module(f"professad_tpu_torch.{mod}")
        assert all(hasattr(m, n) for n in names), mod
    from professad_tpu_torch.system import System  # noqa: F401


def test_basic_tutorial_flow_through_compat_imports():
    """The reference's basic_example.py with the package name changed, at
    500 eV, on the CPU."""
    from professad_tpu_torch.system import System
    from professad_tpu_torch.functionals import (IonIon, IonElectron,
                                                 Hartree, WangTeter,
                                                 PerdewBurkeErnzerhof)
    from professad_tpu_torch.crystal_tools import get_cell

    terms = [IonIon, IonElectron, Hartree, WangTeter, PerdewBurkeErnzerhof]
    box_vecs, frac = get_cell("fcc", vol_per_atom=24.8,
                              coord_type="fractional", device="cpu")
    ions = [["Al", pot("al.gga.recpot"), frac]]
    shape = System.ecut2shape(500, box_vecs)
    system = System(box_vecs, shape, ions, terms, units="a",
                    coord_type="fractional", device="cpu")
    system.optimize_density(ntol=1e-7, conv_target="dE", n_method="LBFGS")
    assert np.isfinite(system.energy("eV"))
    assert system.check_density_convergence("dEdchi") < 1e-3
    assert system.check_density_convergence("euler") < 1e-2


def _system(device="cpu"):
    from professad_tpu_torch import System
    from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                            WangTeter, PerdewBurkeErnzerhof)
    box = 4.05 * np.array([[0.5, 0.5, 0.0], [0.0, 0.5, 0.5],
                           [0.5, 0.0, 0.5]])
    ions = [["Al", pot("al.gga.recpot"), np.zeros((1, 3))]]
    terms = [IonIon, IonElectron, Hartree, WangTeter, PerdewBurkeErnzerhof]
    return System(box, (8, 8, 8), ions, terms, units="a",
                  coord_type="fractional", device=device)


def test_requires_grad_warns_and_default_is_silent():
    s = _system()
    calls = {"density": lambda: s.density(requires_grad=True),
             "energy": lambda: s.energy(requires_grad=True),
             "functional_derivative":
                 lambda: s.functional_derivative(requires_grad=True),
             "pressure": lambda: s.pressure(requires_grad=True),
             "bulk_modulus": lambda: s.bulk_modulus(requires_grad=True)}
    for name, call in calls.items():
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            out = call()
        assert any("gs_property_fn" in str(w.message)
                   and name in str(w.message) for w in rec), name
        assert not (torch.is_tensor(out) and out.requires_grad)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        s.density()
        s.energy()
        s.functional_derivative()
        s.pressure()
    assert not rec


def test_step_timer_and_trace(tmp_path):
    from professad_tpu_torch.utils import StepTimer, trace, annotate
    timer = StepTimer()
    assert timer.summary() == {"steps": 0}
    timer.start()
    x = torch.ones(8)
    for _ in range(3):
        x = x * 2.0
        timer.tick(x, [x, {"y": x}])
    summ = timer.summary()
    assert summ["steps"] == 3 and summ["total_s"] > 0
    assert summ["min_s"] <= summ["mean_s"] <= summ["max_s"]
    with trace(str(tmp_path)):
        with annotate("port-step"):
            torch.fft.rfftn(torch.ones(8, 8, 8))
    files = os.listdir(tmp_path)
    assert any(f.endswith(".json") for f in files), files


def test_interpolate_recpot_matches_jax():
    from professad_tpu.models.ions import interpolate_recpot as jinterp
    from professad_tpu_torch.ion_utils import interpolate_recpot
    ks = np.concatenate([[0.0], np.random.default_rng(0).uniform(
        0.0, 12.0, 200), [40.0]])   # k = 0, the table, past its end
    want = np.asarray(jinterp(pot("al.gga.recpot"), jnp.asarray(ks)))
    got = interpolate_recpot(pot("al.gga.recpot"), torch.tensor(ks))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def test_set_device_round_trip():
    """set_device("cpu") moves nothing it should not, and the next
    optimization lands where one on a fresh System does."""
    ref = _system()
    ref.optimize_density(ntol=1e-9, jit_loop=True, precondition=True,
                         n_step_size=1.0)
    s = _system()
    s.set_device("cpu")
    assert s.device() == torch.device("cpu")
    s.optimize_density(ntol=1e-9, jit_loop=True, precondition=True,
                       n_step_size=1.0)
    assert s.energy() == ref.energy()
    assert torch.equal(s.density(), ref.density())


def test_import_pulls_in_no_jax():
    code = ("import sys, professad_tpu_torch\n"
            + "".join(f"import professad_tpu_torch.{m}\n" for m in COMPAT)
            + "import professad_tpu_torch.utils\n"
            "import professad_tpu_torch.parallel.dryrun\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'professad_tpu' or "
            "m.startswith('professad_tpu.')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
