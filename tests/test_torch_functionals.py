"""The port's WT-family, local kinetic and LDA-family functionals against
the JAX package: energies, fused potentials, autograd functional
derivatives and the analytic-path gate, f64 on the CPU at 16^3, and the
PROFESS-4 bcc-Li Smargiassi-Madden golden energy at 18^3.

Inputs are made with numpy from a seed and go through both packages.
Tolerance: rtol 1e-10 (the JAX suite's f64 derivative-identity bound) for
energies and potentials, 1e-4 eV for the golden energy.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from professad_tpu import models as jm
from professad_tpu.models import potentials as jpot
from professad_tpu_torch import models as tm
from professad_tpu_torch.models import potentials as tpot
from professad_tpu_torch.ops.autodiff import get_functional_derivative
from professad_tpu_torch import System
from paths import pot

SHAPE = (16, 16, 16)
RTOL = 1e-10


def _pg(module, preset):
    f = module.PauliGaussian()
    getattr(f, preset)()
    return f


# name -> (JAX term, port term); the trainable ones as module instances
CASES = {
    "Perrot": lambda: (jm.Perrot, tm.Perrot),
    "SmargiassiMadden": lambda: (jm.SmargiassiMadden, tm.SmargiassiMadden),
    "WangGovindCarter98": lambda: (jm.WangGovindCarter98,
                                   tm.WangGovindCarter98),
    "WTSF_1+x": lambda: (jm.WangTeterStyleFunctional(
        (0.8, 0.7, lambda x: 1.0 + x)), tm.WangTeterStyleFunctional(
        (0.8, 0.7, lambda x: 1.0 + x))),
    "WTSF_exp": lambda: (jm.WangTeterStyleFunctional(
        (5.0 / 6.0, 5.0 / 6.0, jnp.exp)), tm.WangTeterStyleFunctional(
        (5.0 / 6.0, 5.0 / 6.0, torch.exp))),
    "vWGTF1": lambda: (jm.vWGTF1, tm.vWGTF1),
    "vWGTF2": lambda: (jm.vWGTF2, tm.vWGTF2),
    "LuoKarasievTrickey": lambda: (jm.LuoKarasievTrickey,
                                   tm.LuoKarasievTrickey),
    "PG1": lambda: (_pg(jm, "set_PG1"), _pg(tm, "set_PG1")),
    "PGS": lambda: (_pg(jm, "set_PGS"), _pg(tm, "set_PGS")),
    "PGSL025": lambda: (_pg(jm, "set_PGSL025"), _pg(tm, "set_PGSL025")),
    "PGSLr": lambda: (_pg(jm, "set_PGSLr"), _pg(tm, "set_PGSLr")),
    "lda_exchange": lambda: (jm.lda_exchange, tm.lda_exchange),
    "perdew_zunger_correlation": lambda: (jm.perdew_zunger_correlation,
                                          tm.perdew_zunger_correlation),
    "perdew_wang_correlation": lambda: (jm.perdew_wang_correlation,
                                        tm.perdew_wang_correlation),
    "chachiyo_correlation": lambda: (jm.chachiyo_correlation,
                                     tm.chachiyo_correlation),
    "PerdewZunger": lambda: (jm.PerdewZunger, tm.PerdewZunger),
    "PerdewWang": lambda: (jm.PerdewWang, tm.PerdewWang),
    "Chachiyo": lambda: (jm.Chachiyo, tm.Chachiyo),
}


@pytest.fixture(scope="module")
def state():
    """A skewed cell and a density that spans rs < 1 and rs > 1 (both
    branches of PZ81)."""
    rng = np.random.default_rng(7)
    box = 6.1 * np.eye(3) + 0.2 * rng.standard_normal((3, 3))
    den = 0.05 + 0.4 * rng.random(SHAPE)
    return box, den


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) <= rtol * np.max(np.abs(b))


@pytest.mark.parametrize("name", list(CASES))
def test_energy_matches_jax(state, name):
    box, den = state
    jf, tf = CASES[name]()
    E_ref = float(jf(jnp.asarray(box), jnp.asarray(den)))
    E = tf(torch.tensor(box), torch.tensor(den)).detach()
    assert E.dtype == torch.float64
    assert abs(float(E) - E_ref) <= RTOL * abs(E_ref), (float(E), E_ref)


@pytest.mark.parametrize("name", list(CASES))
def test_fused_potential_matches_jax_and_autograd(state, name):
    """value_and_potential against the JAX package's, and its potential
    against the autograd functional derivative of the energy body; the
    trainable modules are passed as their bound ``forward``."""
    box, den = state
    jf, tf = CASES[name]()
    jt = jf.forward if hasattr(jf, "forward") else jf
    tt = tf.forward if hasattr(tf, "forward") else tf
    vext = np.zeros(SHAPE)
    E_ref, p_ref = jpot.value_and_potential(
        [jt], jnp.asarray(box), jnp.asarray(den), jnp.asarray(vext))
    b, d = torch.tensor(box), torch.tensor(den)
    E, p = tpot.value_and_potential([tt], b, d, torch.tensor(vext))
    assert abs(float(E) - float(E_ref)) <= RTOL * abs(float(E_ref))
    assert _close(p.numpy(), p_ref)
    g = get_functional_derivative(b, d, tf)
    assert _close(p.numpy(), g.detach().numpy())
    assert not p.requires_grad


@pytest.mark.parametrize("name", list(CASES))
def test_supported_terms_agrees_with_jax(name):
    """Both packages take each functional on the analytic path, as the
    module and as its bound ``forward``."""
    jf, tf = CASES[name]()
    for jt, tt in ((jf, tf), (getattr(jf, "forward", jf),
                              getattr(tf, "forward", tf))):
        assert jpot.supported_terms([jm.IonIon, jt]) is True
        assert tpot.supported_terms([tm.IonIon, tt]) is True


# PauliGaussian overflows in f32 below ~1e-10 of the mean density (its
# s^4 and q^2 terms), in the JAX package as here (ROADMAP section C)
LOW_DENSITY_F32 = [n for n in CASES if not n.startswith("PG")]


def _f32_sweep(name, box, den):
    _, tf = CASES[name]()
    f32 = dict(dtype=torch.float32)
    E, p = tpot.value_and_potential(
        [tf], torch.tensor(box, **f32), torch.tensor(den, **f32),
        torch.zeros(SHAPE, **f32))
    assert p.dtype == torch.float32
    return bool(torch.isfinite(E)) and bool(torch.isfinite(p).all())


@pytest.mark.parametrize("name", list(CASES))
def test_f32_potential_is_finite_at_uniform_density(state, name):
    """s = 0 and |grad n| = 0 everywhere: the double-where guards hold."""
    assert _f32_sweep(name, state[0], np.full(SHAPE, 0.2))


@pytest.mark.parametrize("name", LOW_DENSITY_F32)
def test_f32_potential_is_finite_as_density_falls_to_zero(state, name):
    """The density falls to 1e-10 of its mean over half the cell."""
    box, den = state
    den = den.copy()
    den[:8] = 0.2 * 1e-10
    assert _f32_sweep(name, box, den)


def test_module_term_and_bound_forward_dispatch_alike(state):
    """The module itself and its ``forward`` give the same fused sweep."""
    box, den = state
    f = tm.WangTeterStyleFunctional((5.0 / 6.0, 5.0 / 6.0, torch.exp))
    vext = torch.zeros(SHAPE, dtype=torch.float64)
    args = (torch.tensor(box), torch.tensor(den), vext)
    E1, p1 = tpot.value_and_potential([f], *args)
    E2, p2 = tpot.value_and_potential([f.forward], *args)
    assert float(E1) == float(E2) and torch.equal(p1, p2)


def test_stabilizer_must_be_one_at_zero():
    with pytest.raises(ValueError, match="f\\(0\\) = 1"):
        tm.WangTeterStyleFunctional((0.5, 0.5, lambda x: 2.0 + x))


def test_params_carry_across_and_save_load(tmp_path):
    """A JAX functional's parameters load into the port's module, and the
    port's checkpoint restores them."""
    from professad_tpu_torch.convert import functional_params_from_jax
    jf = jm.PauliGaussian((1.1, 0.3, 0.2, 0.1))
    tf = tm.PauliGaussian()
    tf.load_params(functional_params_from_jax(
        {k: np.asarray(v) for k, v in jf.params.items()}))
    assert {k: v.item() for k, v in tf.params.items()} == pytest.approx(
        dict(mu=1.1, beta=0.3, lamb=0.2, sigma=0.1), rel=1e-15)
    path = tmp_path / "pg.pkl"
    tf.save(path)
    back = tm.PauliGaussian.load(path)
    assert all(back.params[k].item() == tf.params[k].item()
               for k in tf.params.keys())
    with pytest.raises(KeyError):
        tf.load_params({"alpha": 1.0})


def _bcc_li(device="cpu"):
    return System(3.48 * np.eye(3), (18, 18, 18),
                  [["Li", pot("li.gga.recpot"),
                    np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]])]],
                  [tm.IonIon, tm.IonElectron, tm.Hartree,
                   tm.SmargiassiMadden, tm.PerdewBurkeErnzerhof],
                  units="a", coord_type="fractional", device=device)


def test_golden_energy_bcc_li_sm():
    """PROFESS-4 bcc Li with Smargiassi-Madden + PBE (18^3, the case of
    tests/test_match_profess4.py) through the TPGD analytic path and the
    default optimize_density(), atol 1e-4 eV."""
    s = _bcc_li()
    n_it, conv = s.optimize_density(ntol=1e-7, n_method="TPGD",
                                    analytic=True, precondition=True,
                                    n_step_size=1.0, skip_iters=2,
                                    jit_loop=True)
    assert conv, n_it
    assert abs(s.energy("eV") - (-14.741886997024537)) < 1e-4
    s.initialize_density()
    n_it, conv = s.optimize_density(ntol=1e-7)
    assert conv, n_it
    assert abs(s.energy("eV") - (-14.741886997024537)) < 1e-4
