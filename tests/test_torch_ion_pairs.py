"""The bounded ion-ion pair sum of the port (``models/ions.py``
``ion_interaction_sum``: an autograd Function that keeps no graph across
image chunks, with the CUDA kernel ``csrc/ion_pairs.cu`` for CUDA tensors)
on the CPU, in f64:

- against plain autograd of the chunked torch form the port had before
  (energy, forces, the cell gradient that stress takes, and a second
  derivative through ``create_graph``), and against the JAX package's
  ``ion_interaction_sum`` (energy, forces, cell gradient, a Hessian-vector
  product), on seeded, displaced hcp Mg and fcc Al cells of 2 to 32 ions,
  at 1e-12 relative;
- ``chunk=`` cases: the backward recomputes chunk by chunk;
- the graph it keeps: four saved tensors whatever the number of chunks;
- the kernel's partial sums put together as the wrapper does (a plain
  emulation of the kernel's grid stands in for the launch here), for an
  image table with and without -s beside every s, with the
  ``pair_launches`` / ``pair_terms`` counters and the ``ions.pair_sum``
  scope.

The kernel itself runs only on the card: ``test_torch_cuda_ion_pairs.py``.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from professad_tpu.models import ions as jions
from professad_tpu_torch.models import ions
from professad_tpu_torch.ops.grid import safe_sqrt, volume

FCC = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0],
                [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]])
HCP = np.array([[1 / 3, 2 / 3, 0.75], [2 / 3, 1 / 3, 0.25]])
A_PER_B = 0.529177210903


def _cell(kind, reps, seed):
    """(box, displaced Cartesian coords, charges, Rc, Rd) [bohr] of an fcc
    Al (a = 4.0627 A, Z = 3) or hcp Mg (23.151 A^3/atom, c/a 1.630, Z = 2)
    supercell, every ion displaced by a Gaussian of 0.10 A a component;
    Rc four heights of the cell, Rd as ``System`` takes it from Rc."""
    reps = np.asarray(reps)
    if kind == "al":
        prim, basis, z = 4.0627 * np.eye(3), FCC, 3.0
    else:
        a = (2 * 23.151 / (np.sqrt(3) / 2 * 1.630)) ** (1 / 3)
        prim = a * np.array([[1.0, 0, 0], [-0.5, np.sqrt(3) / 2, 0],
                             [0, 0, 1.630]])
        basis, z = HCP, 2.0
    cells = np.stack(np.meshgrid(*(np.arange(r) for r in reps),
                                 indexing="ij"), -1).reshape(-1, 3)
    frac = ((cells[:, None, :] + basis[None]) / reps).reshape(-1, 3)
    box = prim * reps[:, None] / A_PER_B
    rng = np.random.default_rng(seed)
    cart = frac @ box + 0.1 / A_PER_B * rng.standard_normal(frac.shape)
    h = 1.0 / np.sqrt(np.sum(np.linalg.inv(box.T) ** 2, axis=1))
    Rc = 4.0 * h.max()
    Rd = float(np.sqrt(h.max() * Rc / 3.0))
    return box, cart, np.full(len(frac), z), Rc, Rd


CASES = {"mg2": ("mg", (1, 1, 1), 1), "mg16": ("mg", (2, 2, 2), 2),
         "al4": ("al", (1, 1, 1), 3), "al32": ("al", (2, 2, 2), 4)}


def _plain(box, coords, charges, Rc, Rd, shifts, chunk=None):
    """The chunked torch form as the port had it: autograd of it keeps
    every chunk's graph."""
    n = coords.shape[0]
    shifts_t = torch.as_tensor(shifts, dtype=coords.dtype)
    chunk = chunk or max(1, ions._MAX_PAIRS // (n * n))
    zz = charges[:, None] * charges[None, :]
    E = torch.zeros((), dtype=coords.dtype)
    Q = torch.zeros(n, dtype=coords.dtype)
    for s in range(0, shifts_t.shape[0], chunk):
        disp = (coords[None, None] + (shifts_t[s:s + chunk] @ box)[:, None,
                                                                    None]
                - coords[None, :, None])
        r = safe_sqrt(torch.sum(disp * disp, dim=-1))
        valid = (r < Rc) & (r > 1e-12)
        r_safe = torch.where(valid, r, 1.0)
        E = E + 0.5 * torch.sum(torch.where(
            valid, zz * torch.special.erfc(r_safe / Rd) / r_safe, 0.0))
        Q = Q + torch.sum(torch.where(valid, charges[None, None, :], 0.0),
                          dim=(0, 2))
    rho = torch.sum(charges) / volume(box)
    aux = (0.75 / np.pi) * Q / rho
    Ra = torch.sign(aux) * torch.abs(aux) ** (1.0 / 3.0)
    sp = float(np.sqrt(np.pi))
    return E + torch.sum(
        -np.pi * charges * rho * Ra ** 2
        + np.pi * charges * rho * (Ra ** 2 - 0.5 * Rd * Rd)
        * torch.special.erf(Ra / Rd)
        + sp * charges * rho * Ra * Rd * torch.exp(-Ra ** 2 / Rd ** 2)
        - charges ** 2 / sp / Rd)


def _derivatives(fn, box, cart, frac, v):
    """(E, dE/dR, dE/dh with the ions carried by the cell, the
    Hessian-vector product d(dE/dR . v)/dR) of ``fn(h, coords)``."""
    R = torch.tensor(cart, requires_grad=True)
    h = torch.tensor(box)
    E = fn(h, R)
    (g,) = torch.autograd.grad(E, R, create_graph=True)
    (hv,) = torch.autograd.grad(torch.sum(g * torch.tensor(v)), R)
    hh = torch.tensor(box, requires_grad=True)
    (gh,) = torch.autograd.grad(fn(hh, torch.tensor(frac) @ hh), hh)
    return float(E.detach()), g.detach().numpy(), gh.numpy(), hv.numpy()


def _close(got, want, rtol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert np.max(np.abs(got - want)) <= rtol * np.max(np.abs(want)), \
        (np.max(np.abs(got - want)), np.max(np.abs(want)))


@pytest.mark.parametrize("case", list(CASES))
def test_bounded_sum_matches_plain_autograd(case):
    box, cart, z, Rc, Rd = _cell(*CASES[case])
    frac = cart @ np.linalg.inv(box)
    shifts = ions.neighbor_shifts(box, Rc)
    v = np.random.default_rng(9).standard_normal(cart.shape)
    Z = torch.tensor(z)
    got = _derivatives(lambda h, R: ions.ion_interaction_sum(
        h, R, Z, Rc, Rd, shifts=shifts), box, cart, frac, v)
    want = _derivatives(lambda h, R: _plain(h, R, Z, Rc, Rd, shifts),
                        box, cart, frac, v)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("case", ["mg2", "al4", "al32"])
def test_bounded_sum_matches_the_jax_package(case):
    box, cart, z, Rc, Rd = _cell(*CASES[case])
    frac = cart @ np.linalg.inv(box)
    shifts = jions.neighbor_shifts(box, Rc)
    v = np.random.default_rng(9).standard_normal(cart.shape)
    Z = torch.tensor(z)
    got = _derivatives(lambda h, R: ions.ion_interaction_sum(
        h, R, Z, Rc, Rd, shifts=shifts), box, cart, frac, v)

    def jE(h, R):
        return jions.ion_interaction_sum(h, R, jnp.asarray(z), Rc, Rd,
                                         shifts=shifts)
    jh, jR = jnp.asarray(box), jnp.asarray(cart)
    E = float(jE(jh, jR))
    g = jax.grad(jE, argnums=1)(jh, jR)
    hv = jax.grad(lambda R: jnp.sum(jax.grad(jE, argnums=1)(jh, R)
                                    * jnp.asarray(v)))(jR)
    gh = jax.grad(lambda h: jE(h, jnp.asarray(frac) @ h))(jh)
    for a, b in zip(got, (E, g, gh, hv)):
        _close(a, np.asarray(b))


@pytest.mark.parametrize("chunk", [1, 7, 256, None])
def test_chunked_backward(chunk):
    """Energy, forces and cell gradient for every chunking, against plain
    autograd of the unchunked-by-default torch form."""
    box, cart, z, Rc, Rd = _cell(*CASES["al4"])
    frac = cart @ np.linalg.inv(box)
    shifts = ions.neighbor_shifts(box, Rc)
    assert len(shifts) > 256
    v = np.zeros_like(cart)
    Z = torch.tensor(z)
    got = _derivatives(lambda h, R: ions.ion_interaction_sum(
        h, R, Z, Rc, Rd, shifts=shifts, chunk=chunk), box, cart, frac, v)
    want = _derivatives(lambda h, R: _plain(h, R, Z, Rc, Rd, shifts),
                        box, cart, frac, v)
    for a, b in zip(got[:3], want[:3]):
        _close(a, b)


@pytest.mark.parametrize("chunk", [1, 50])
def test_graph_holds_no_chunk(chunk):
    """What autograd saves for the pair sum does not grow with the number
    of chunks: the Function saves its four inputs (the plain form saves
    several tensors a chunk)."""
    box, cart, z, Rc, Rd = _cell(*CASES["mg2"])
    shifts = ions.neighbor_shifts(box, Rc)
    saved = []

    def pack(t):
        saved.append(t)
        return t

    R = torch.tensor(cart, requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        ions.ion_interaction_sum(torch.tensor(box), R, torch.tensor(z), Rc,
                                 Rd, shifts=shifts, chunk=chunk)
    bounded = len(saved)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        _plain(torch.tensor(box), R, torch.tensor(z), Rc, Rd, shifts,
               chunk=chunk)
    n_chunks = -(-len(shifts) // chunk)
    assert bounded < 40
    assert len(saved) - bounded > 4 * n_chunks


def _emulated_launch(pos, z, tvec, Rc, Rd, grad):
    """The kernel's partial sums, in its grid and layout, from plain torch
    (``csrc/ion_pairs.cu``: block columns of 128 ions i, block rows of sb
    shifts)."""
    n, S, T = pos.shape[0], tvec.shape[0], 128
    nx = -(-n // T)
    sb = max(1, -(-nx * S // ions._PAIR_BLOCKS))
    ny = -(-S // sb)
    d = pos[None, None, :, :] - (pos[None, :, None, :] - tvec[:, None, None])
    r2 = torch.sum(d * d, dim=-1)
    r = torch.sqrt(r2)
    ok = (r2 < Rc * Rc * (1 + 1e-12)) & (r < Rc) & (r > 1e-12)
    r = torch.where(ok, r, 1.0)
    x = r / Rd
    zz = z[:, None] * z[None, :]
    ep = torch.where(ok, zz * torch.special.erfc(x) / r, 0.0)
    qq = torch.where(ok, z[None, None, :].expand_as(ep), 0.0)
    f = torch.where(ok, -(zz * 2 / (np.sqrt(np.pi) * Rd) * torch.exp(-x * x)
                          + ep) / (r * r), 0.0)
    G = f[..., None] * d
    Gi = torch.where(torch.eye(n, dtype=torch.bool)[None, :, :, None], 0.0,
                     G)
    rows = [slice(y * sb, min(S, (y + 1) * sb)) for y in range(ny)]
    e = torch.stack([ep[s].sum((0, 2)) for s in rows])
    q = torch.stack([qq[s].sum((0, 2)) for s in rows])
    if not grad:
        return e, q, None, None
    g = torch.stack([Gi[s].sum((0, 2)) for s in rows])
    w = torch.stack([G[:, x * T:(x + 1) * T].sum((1, 2)) for x in range(nx)])
    return e, q, g, w


@pytest.mark.parametrize("grad", [False, True])
def test_kernel_partials_and_counters(monkeypatch, grad):
    """The wrapper's reduction of the kernel's partials (the factor 2 of
    pairs met from both ends, the cell gradient from the per-shift rows)
    against the torch form, through the Function as CUDA tensors take it;
    each call adds one launch and ions^2 x images candidate terms, inside
    an ``ions.pair_sum`` scope."""
    monkeypatch.setattr(ions, "_pair_launch", _emulated_launch)
    box, cart, z, Rc, Rd = _cell(*CASES["mg16"])
    shifts_t = torch.tensor(ions.neighbor_shifts(box, Rc))
    R = torch.tensor(cart, requires_grad=True)
    h = torch.tensor(box, requires_grad=True)
    Z = torch.tensor(z)
    l0, t0 = ions.pair_launches, ions.pair_terms
    with torch.profiler.profile() as prof:
        P, Q, _, _ = ions._IonPairSum.apply(R, h, Z, shifts_t, Rc, Rd, 64,
                                            True, grad)
        gR, gh = torch.autograd.grad(P, (R, h))
    assert ions.pair_launches == l0 + 1
    assert ions.pair_terms == t0 + 16 * 16 * shifts_t.shape[0]
    assert any(e.name == "ions.pair_sum" for e in prof.events())
    P0, Q0 = ions._pair_energy_torch(R.detach(), h.detach(), Z, shifts_t,
                                     Rc, Rd, 64)
    gR0, gh0 = ions._pair_grads_torch(R.detach(), h.detach(), Z, shifts_t,
                                      Rc, Rd, 64)
    _close(float(P.detach()), float(P0))
    assert torch.equal(Q, Q0)
    _close(gR, gR0)
    _close(gh, gh0)


@pytest.mark.parametrize("grad", [False, True])
def test_half_table_partials(monkeypatch, grad):
    """An image table without -s beside s: the energy and Q of one launch,
    the gradients from a second launch over the negated table (two launches
    and twice the candidate terms), against the torch form of that table."""
    monkeypatch.setattr(ions, "_pair_launch", _emulated_launch)
    box, cart, z, Rc, Rd = _cell(*CASES["mg16"])
    sh = ions.neighbor_shifts(box, Rc)
    sh = sh[np.lexsort(sh.T[::-1])][: len(sh) // 2 + 1]
    assert not ions._symmetric(sh)
    shifts_t = torch.tensor(sh)
    R = torch.tensor(cart, requires_grad=True)
    h = torch.tensor(box, requires_grad=True)
    Z = torch.tensor(z)
    l0, t0 = ions.pair_launches, ions.pair_terms
    P, Q, _, _ = ions._IonPairSum.apply(R, h, Z, shifts_t, Rc, Rd, 64, True,
                                        grad)
    launches = 2 if grad else 1
    assert ions.pair_launches == l0 + launches
    assert ions.pair_terms == t0 + launches * 16 * 16 * len(sh)
    P0, Q0 = ions._pair_energy_torch(R.detach(), h.detach(), Z, shifts_t,
                                     Rc, Rd, 64)
    _close(float(P.detach()), float(P0))
    assert torch.equal(Q, Q0)
    if grad:
        gR, gh = torch.autograd.grad(P, (R, h))
        gR0, gh0 = ions._pair_grads_torch(R.detach(), h.detach(), Z,
                                          shifts_t, Rc, Rd, 64)
        _close(gR, gR0)
        _close(gh, gh0)


def test_cpu_path_counts_no_launch():
    box, cart, z, Rc, Rd = _cell(*CASES["mg2"])
    l0 = ions.pair_launches
    ions.ion_interaction_sum(torch.tensor(box), torch.tensor(cart),
                             torch.tensor(z), Rc, Rd)
    assert ions.pair_launches == l0


def test_symmetric_tables():
    box, _, _, Rc, _ = _cell(*CASES["al4"])
    sh = ions.neighbor_shifts(box, Rc)
    assert ions._symmetric(sh)
    assert ions._symmetric(sh[::-1])
    assert not ions._symmetric(sh[np.lexsort(sh.T[::-1])][: len(sh) // 2])
