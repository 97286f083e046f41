"""The ion-ion pair kernel (``csrc/ion_pairs.cu``) on the card (marker
``cuda``; skips without a CUDA device), against the port's torch form of
the same sum on the card: fcc Al cells of 16, 256 and 2048 ions displaced
by a seeded 0.10 A Gaussian, Rc six heights of the cell (the benchmark's
rule, less the images exactly on it), in f64.

Tolerances: the energy to 1e-12 relative and the neighbour charges Q
exactly (sums of the same charges over the same pairs; the kernel sums in
another order); forces to 1e-10 Ha/bohr and the stress to 1e-10 Ha/bohr^3
(the kernel's per-ion sums of ~1e6 terms round at ~1e-14 of their
magnitudes).  Also for an image table without -s beside s (two
launches).  Besides: a second derivative through the card path, the
counters, and the memory the forces add over the energy at 2048 ions.  No JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_ion_pairs.py
"""

import numpy as np
import pytest
import torch

from professad_tpu_torch.models import ions
from professad_tpu_torch.ops.grid import volume

FCC = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0],
                [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]])
A_PER_B = 0.529177210903


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _al(reps, seed=7):
    """(box, Cartesian coords, charges, Rc, Rd, shifts) [bohr] of fcc Al
    (a = 4.0627 A) repeated ``reps``, displaced 0.10 A a component."""
    reps = np.asarray(reps)
    cells = np.stack(np.meshgrid(*(np.arange(r) for r in reps),
                                 indexing="ij"), -1).reshape(-1, 3)
    frac = ((cells[:, None, :] + FCC[None]) / reps).reshape(-1, 3)
    box = 4.0627 * np.diag(reps) / A_PER_B
    rng = np.random.default_rng(seed)
    cart = frac @ box + 0.1 / A_PER_B * rng.standard_normal(frac.shape)
    h = 1.0 / np.sqrt(np.sum(np.linalg.inv(box.T) ** 2, axis=1))
    # six heights and a hair: at six exactly, the images s h with |s| = 6
    # of every ion sit on the cutoff, and which side of it they fall is
    # rounding, which the kernel and the torch form do in other orders
    Rc = 6.0 * h.max() * (1.0 + 1e-9)
    Rd = float(np.sqrt(h.max() * Rc / 3.0))
    return box, cart, np.full(len(frac), 3.0), Rc, Rd, \
        ions.neighbor_shifts(box, Rc)


def _sum(box, cart, z, Rc, Rd, shifts, device, kernel):
    """(E, Q, dE/dR, stress) of the pair part of the sum, through the
    kernel's path or the torch form, on ``device``: the corrections depend
    on Q (compared exactly) and on the volume alone."""
    t = dict(dtype=torch.float64, device=device)
    h = torch.tensor(box, **t).requires_grad_(True)
    R = torch.tensor(cart, **t).requires_grad_(True)
    chunk = max(1, ions._MAX_PAIRS // len(z) ** 2)
    P, Q, _, _ = ions._IonPairSum.apply(R, h, torch.tensor(z, **t),
                                        torch.tensor(shifts, **t), Rc, Rd,
                                        chunk, kernel, True)
    gR, gh = torch.autograd.grad(P, (R, h))
    # the ions carried by the cell: dP/dh + frac^T dP/dR
    frac = torch.tensor(cart @ np.linalg.inv(box), **t)
    gh = gh + frac.T @ gR
    h = h.detach()
    return 0.5 * P.detach(), Q, 0.5 * gR, 0.5 * gh.T @ h / volume(h)


def _half(shifts):
    """The first half of the sorted table and s = 0: -s is missing beside
    most s."""
    return shifts[np.lexsort(shifts.T[::-1])][: len(shifts) // 2 + 1]


@pytest.mark.cuda
@pytest.mark.parametrize("reps, half", [((2, 2, 1), False),
                                        ((4, 4, 4), False),
                                        ((8, 8, 8), False),
                                        ((4, 4, 4), True)],
                         ids=["16", "256", "2048", "256-half"])
def test_kernel_matches_torch_form(cuda, reps, half):
    case = _al(reps)
    if half:
        case = case[:-1] + (_half(case[-1]),)
    E, Q, gR, st = _sum(*case, cuda, kernel=True)
    E0, Q0, gR0, st0 = _sum(*case, cuda, kernel=False)
    gaps = (float(E - E0) / float(E0), float((Q - Q0).abs().max()),
            float((gR - gR0).abs().max()), float((st - st0).abs().max()))
    assert abs(gaps[0]) <= 1e-12 and gaps[1] == 0, gaps
    assert gaps[2] <= 1e-10 and gaps[3] <= 1e-10, gaps


@pytest.mark.cuda
def test_public_sum_takes_the_kernel_and_counts(cuda):
    box, cart, z, Rc, Rd, shifts = _al((4, 4, 4))
    t = dict(dtype=torch.float64, device=cuda)
    l0, t0 = ions.pair_launches, ions.pair_terms
    R = torch.tensor(cart, **t).requires_grad_(True)
    E = ions.ion_interaction_sum(torch.tensor(box, **t), R,
                                 torch.tensor(z, **t), Rc, Rd, shifts=shifts)
    (g,) = torch.autograd.grad(E, R)
    torch.cuda.synchronize()
    # one launch computes the energy and its gradients; the backward
    # launches nothing
    assert ions.pair_launches == l0 + 1
    assert ions.pair_terms == t0 + 256 * 256 * len(shifts)
    Ec = ions.ion_interaction_sum(torch.tensor(box), torch.tensor(cart),
                                  torch.tensor(z), Rc, Rd, shifts=shifts)
    assert abs(float(E) - float(Ec)) <= 1e-12 * abs(float(Ec))


@pytest.mark.cuda
def test_second_derivative_and_half_table_on_the_card(cuda):
    """A Hessian-vector product through the card path equals the CPU's,
    also for an image table without -s beside s, whose forward takes two
    launches (the second for the j ends' gradient)."""
    box, cart, z, Rc, Rd, shifts = _al((1, 1, 1))
    v = np.random.default_rng(3).standard_normal(cart.shape)

    def hvp(device, sh):
        t = dict(dtype=torch.float64, device=device)
        R = torch.tensor(cart, **t).requires_grad_(True)
        E = ions.ion_interaction_sum(torch.tensor(box, **t), R,
                                     torch.tensor(z, **t), Rc, Rd, shifts=sh)
        (g,) = torch.autograd.grad(E, R, create_graph=True)
        (hv,) = torch.autograd.grad(torch.sum(g * torch.tensor(v, **t)), R)
        return float(E), g.detach().cpu().numpy(), hv.cpu().numpy()

    def rel(a, b):
        return [float(np.max(np.abs(np.asarray(x) - y)) / np.max(np.abs(y)))
                for x, y in zip(a, b)]

    gaps = rel(hvp(cuda, shifts), hvp("cpu", shifts))
    assert max(gaps) <= 1e-12, gaps
    half = _half(shifts)
    l0 = ions.pair_launches
    gaps = rel(hvp(cuda, half), hvp("cpu", half))
    assert max(gaps) <= 1e-12, gaps
    assert ions.pair_launches == l0 + 2


@pytest.mark.cuda
def test_forces_memory_at_2048_ions(cuda):
    """What the forces add to the device's peak over the energy alone: the
    kernel's partial sums, well under 1 GiB (the torch form's graph would
    hold ~650 GB)."""
    box, cart, z, Rc, Rd, shifts = _al((8, 8, 8))
    t = dict(dtype=torch.float64, device=cuda)
    h, Z = torch.tensor(box, **t), torch.tensor(z, **t)
    peaks = []
    for grad in (False, True):
        R = torch.tensor(cart, **t).requires_grad_(grad)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.enable_grad():
            E = ions.ion_interaction_sum(h, R, Z, Rc, Rd, shifts=shifts)
            if grad:
                torch.autograd.grad(E, R)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
    assert peaks[1] - peaks[0] < 2 ** 30, peaks
