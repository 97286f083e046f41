"""The port's pencil FFTs, distributed means and pencil_mode on gloo ranks
(P = 2 and 4) against the JAX package's ``parallel.pfft`` under
``shard_map`` over as many host devices, and against the serial port.

One process group per rank count runs every case of this file
(``torch_parallel_cases.pfft_cases``); the groups start when the module's
first test asks for them and run while the JAX references compile
(``ref``).
Bounds: 1e-12 relative in f64; the f32 DC split exact (uniform fields
round-trip bit for bit, per ladder slab too).  The term sets' energies and
gradients are held against the serial port (itself held against the JAX
package in the single-device tests); WT + PBE also against JAX directly.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from professad_tpu.parallel import make_mesh as jmake_mesh
from professad_tpu.parallel import pfft as jpfft
from professad_tpu.models import (IonElectron as jIonElectron,
                                  Hartree as jHartree,
                                  WangTeter as jWangTeter,
                                  PerdewBurkeErnzerhof as jPBE)
from professad_tpu_torch.ops import grid
from professad_tpu_torch.models import ions

import torch_parallel_cases as C
from torch_ranks import start_ranks

RANKS = (2, 4)
G, K = P("grid", None, None), P(None, "grid", None)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    return {p: start_ranks(C.pfft_cases, p, tmp_path_factory.mktemp(f"p{p}"))
            for p in RANKS}


def _smap(fn, p, in_specs, out_specs):
    mesh = jmake_mesh(p, devices=jax.devices("cpu")[:p])
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _term_sum(terms, h, d, v):
    return sum(t(h, d, v) if getattr(t, "__name__", "") == "IonElectron"
               else t(h, d) for t in terms)


@pytest.fixture(scope="module")
def ref(groups):
    """Every JAX reference of the file, computed while the groups run."""
    x = jnp.asarray(C.fft_field().numpy())
    x32 = jnp.asarray((1.5 + C.fft_field()).to(torch.float32).numpy())
    h = jnp.asarray(C.box().numpy())
    out = {}

    def transforms(x_, x32_, h_):
        X_, X32_ = jpfft.prfftn(x_), jpfft.prfftn_dc(x32_)
        means = tuple(getattr(jpfft, m)(x_)
                      for m in ("pmean", "pqmean", "pwmean"))
        means32 = tuple(getattr(jpfft, m)(x32_) for m in ("pqmean", "pwmean"))
        return (X_, X32_, jpfft.pirfftn(X_, C.FFT_SHAPE),
                jpfft.pirfftn_dc(X32_, C.FFT_SHAPE),
                jpfft.pwavevecs(h_, C.FFT_SHAPE), means, means32)

    for p in RANKS:
        X, X32, back, back32, wv, means, means32 = _smap(
            transforms, p, (G, G, P()),
            (K, K, G, G, (K, K, K, K), (P(),) * 3, (P(),) * 2))(x, x32, h)
        r = dict(prfftn=X, prfftn_dc32=X32, pirfftn=back,
                 pirfftn_dc32=back32, pwavevecs=wv)
        r.update(zip(("pmean", "pqmean", "pwmean"), map(float, means)))
        r.update(zip(("pqmean32", "pwmean32"), map(float, means32)))
        out[p] = r
    den_np, v_np = C.fields()
    v = jnp.asarray(v_np)
    terms = [jIonElectron, jHartree, jWangTeter, jPBE]
    E, (gh, gd) = jax.jit(jax.value_and_grad(
        lambda h_, d: _term_sum(terms, h_, d, v), argnums=(0, 1)))(
        h, jnp.asarray(den_np))
    out["wt_pbe"] = (float(E), np.asarray(gd), np.asarray(gh))
    return out


@pytest.mark.parametrize("p", RANKS)
def test_pencil_transforms_match_jax_shard_map(groups, ref, p):
    x = C.fft_field().numpy()
    out, r = groups[p].result(), ref[p]
    assert _rel(out["prfftn"], r["prfftn"]) < 1e-12
    assert _rel(out["pirfftn"], r["pirfftn"]) < 1e-12
    assert _rel(out["pirfftn"], x) < 1e-12
    # f64 passes through the DC split untouched
    assert np.array_equal(out["prfftn_dc64"], out["prfftn"])


@pytest.mark.parametrize("p", RANKS)
def test_pencil_dc_split_f32(groups, ref, p):
    out, r = groups[p].result(), ref[p]
    assert out["prfftn_dc32"].dtype == np.complex64
    assert _rel(out["prfftn_dc32"], r["prfftn_dc32"]) < 2e-6
    assert _rel(out["pirfftn_dc32"], r["pirfftn_dc32"]) < 2e-6
    # per-slab uniform stacks (the ladder's 4-D transforms) and a 3-D
    # uniform field round-trip exactly
    vals = out["dc_vals"]
    for j in range(len(vals)):
        assert np.all(out["dc_roundtrip"][..., j] == vals[j]), j
    assert np.all(out["dc_roundtrip3"] == vals[1])


@pytest.mark.parametrize("p", RANKS)
def test_pwavevecs_match_jax_and_serial(groups, ref, p):
    serial = grid.wavevecs(C.box(), C.FFT_SHAPE)
    out = groups[p].result()
    for got, j, s in zip(out["pwavevecs"], ref[p]["pwavevecs"], serial):
        assert _rel(got, j) < 1e-12
        assert _rel(got, s.numpy()) < 1e-12


@pytest.mark.parametrize("p", RANKS)
def test_distributed_means(groups, ref, p):
    out, r = groups[p].result(), ref[p]
    for name in ("pmean", "pqmean", "pwmean"):
        assert abs(out[name] - r[name]) <= 1e-12 * abs(r[name]), name
    # f32: an f64 energy mean and an f32 working mean, both combined in f64
    assert out["pqmean32_dtype"] == "torch.float64"
    assert out["pwmean32_dtype"] == "torch.float32"
    for name in ("pqmean32", "pwmean32"):
        assert abs(out[name] - r[name]) <= 1e-7 * abs(r[name]), name


@pytest.mark.parametrize("p", RANKS)
def test_ranks_import_no_jax(groups, p):
    """The workers ran the port, its parallel package included, without
    importing JAX or the JAX package."""
    assert groups[p].result()["jax_modules"] == []


@pytest.mark.parametrize("p", RANKS)
def test_gradient_is_not_scaled_by_group_size(groups, p):
    """Differentiating the all-reduced sum on every rank gives P times the
    gradient (the trap); each rank's share E / P gives it once."""
    out = groups[p].result()
    assert np.all(out["trap_all"] == p)
    assert np.all(out["trap_share"] == 1.0)


@pytest.fixture(scope="module")
def serial_terms():
    den_np, v_np = C.fields()
    den, v, h0 = torch.tensor(den_np), torch.tensor(v_np), C.box()
    ref = {}
    for name, terms in C.term_sets():
        d = den.clone().requires_grad_(True)
        h = h0.clone().requires_grad_(True)
        E = _term_sum(terms, h, d, v)
        gd, gh = torch.autograd.grad(E, (d, h))
        ref[name] = (float(E.detach()), gd.numpy(), gh.numpy())
    return ref


@pytest.mark.parametrize("p", RANKS)
@pytest.mark.parametrize("name", [n for n, _ in C.term_sets()])
def test_term_set_energy_and_gradients(groups, serial_terms, p, name):
    """penergy_terms on the slabs: the energy, dE/dn and dE/dh (the psum of
    the ranks' parts) equal the serial port's; the fused sweep's chi
    gradient equals autograd of the distributed energy."""
    E, gd, gh = serial_terms[name]
    out = groups[p].result()
    assert abs(out[f"E_{name}"] - E) <= 1e-12 * abs(E)
    assert _rel(out[f"dEdn_{name}"], gd) < 1e-12
    assert _rel(out[f"dEdh_{name}"], gh) < 1e-12
    Ea, Et = out[f"chiE_{name}"]
    ga, gt = out[f"chig_{name}"]
    assert abs(Ea - Et) <= 1e-12 * abs(Et)
    assert _rel(ga, gt) < 1e-10


@pytest.mark.parametrize("p", RANKS)
def test_wt_pbe_against_jax(groups, ref, p):
    """The benchmark term set on the slabs against the JAX serial energy
    and gradients; the hand-fused WT + PBE bodies against the generic
    ones."""
    E, gd, gh = ref["wt_pbe"]
    out = groups[p].result()
    assert abs(out["E_WT_PBE"] - E) <= 1e-12 * abs(E)
    assert _rel(out["dEdn_WT_PBE"], gd) < 1e-12
    assert _rel(out["dEdh_WT_PBE"], gh) < 1e-12
    # vW in Laplacian form on both; the fused chi gradient too
    assert abs(out["penergy_wt_pbe"] - E) <= 1e-12 * abs(E)
    Ef, gf = out["wt_pbe_fused"]
    assert abs(Ef - out["chiE_WT_PBE"][1]) <= 1e-12 * abs(Ef)
    assert _rel(gf, out["chig_WT_PBE"][1]) < 1e-10


@pytest.mark.parametrize("p", RANKS)
def test_pencil_mode_convolution_skips_the_kernel(groups, p):
    """Under pencil_mode spectral_convolution composes the pencil
    transforms: the spectral_conv kernel wrapper is never called (it would
    take the slab for a whole periodic grid)."""
    den = torch.tensor(C.fields()[0])
    _, _, _, k2 = grid.wavevecs(C.box(), den.shape)
    ref = grid.irfftn(-k2 * grid.rfftn(den), den.shape)
    out = groups[p].result()
    assert out["conv_calls"] == 0
    assert _rel(out["conv"], ref.numpy()) < 1e-12


@pytest.mark.parametrize("p", RANKS)
def test_ladder_terms_on_the_pencils(groups, p):
    den, v = (torch.tensor(a) for a in C.fields())
    h0 = C.box()
    hc = C.hc_term()
    hc.prepare(h0, den)
    E = float(hc.forward_static(h0, den))
    W = hc.aux_arrays()["slabs"]
    from professad_tpu_torch.ops import fieldconv
    conv = fieldconv.ladder_convolution(W, den, den.shape)
    out = groups[p].result()
    assert abs(out["E_hc"][0] - E) <= 1e-12 * abs(E)
    assert abs(out["E_hc"][1] - E) <= 1e-12 * abs(E)
    assert _rel(out["ladder_conv"], conv.numpy()) < 1e-12
    assert "prepare" in out["hc_unprepared"]
    assert out["naive_raises"].startswith("NotImplementedError")


@pytest.mark.parametrize("p", RANKS)
def test_pme_structure_factor_from_slab_spread(groups, p):
    """The PME charge spread as one masked index_add per slab (no halo
    exchange) and the deconvolution on the k-pencil equal the serial
    structure factor and lattice sum."""
    den = torch.tensor(C.fields()[0])
    h0 = C.box()
    cart = torch.tensor([[0.3, 0.2, 0.1], [3.6, 3.9, 3.3], [1.0, 6.5, 7.7]],
                        dtype=torch.float64)
    S = ions.structure_factor_spline(h0, den.shape, cart, 8)
    latt = ions.lattice_sum(h0, den.shape, cart, torch.ones_like(S.real), 8)
    out = groups[p].result()
    assert _rel(out["pme_S"], S.numpy()) < 1e-12
    assert _rel(out["pme_latt"], latt.numpy()) < 1e-12
