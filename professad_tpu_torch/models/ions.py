"""Ion-related utilities: recpot pseudopotentials, the exact and the
particle-mesh Ewald (PME) structure factors, lattice sums and the
real-space ion-ion interaction.

PyTorch port of ``professad_tpu/models/ions.py``.  The PME charge spread
is one ``index_add`` over the whole (order^3 x ions) stencil; its backward
(forces, stress) is a gather.  On CUDA an f64 ``index_add`` accumulates
with atomics, so the charge grid varies at rounding level from run to run.
The JAX package's matrix-unit spread (``_spread_mxu``) is TPU-specific:
every ``method`` runs the scatter here.  Under ``ops.grid.pencil_mode``
``lattice_sum`` and both structure factors work on this rank's slab and
k-pencil (``_spread_scatter_slab``: no halo exchange).

The ion-ion pair sum of ``ion_interaction_sum`` is an autograd Function
that holds no graph across image chunks; for CUDA tensors it is the
kernel ``csrc/ion_pairs.cu`` (no TPU counterpart: the JAX package leaves
the sum to XLA), built by ``ops/cuda_build.py`` at first use.
"""

import ctypes
import functools

import numpy as np
import torch

from ..ops import grid as _grid
from ..ops.cuda_build import build
from ..ops.grid import wavevecs, volume, safe_sqrt, inv3x3, rfftn, expi
from ..ops.interp import interpolate
from ..utils.constants import RECPOT_BOHR, RECPOT_POT_CONV
from ..utils.profiling import annotate

__all__ = ["read_recpot", "get_ion_charge", "interpolate_recpot",
           "structure_factor",
           "structure_factor_spline", "cardinal_b_spline_values",
           "exponential_spline_b", "lattice_sum", "neighbor_shifts",
           "ion_interaction_sum"]

_MAX_PAIRS = 1 << 22  # pair terms per chunk of the ion-ion image sum
_PAIR_BLOCKS = 4096   # blocks the pair kernel aims for: shifts a block

pair_launches = 0
"""Calls of the ion-ion pair kernel (``csrc/ion_pairs.cu``) in this process."""
pair_terms = 0
"""Candidate pair terms (ions^2 x images) the pair kernel examined."""


def read_recpot(path):
    """Parse a CASTEP-style .recpot file (host-side numpy).

    Returns (ks, pot_ft, z): the k grid [1/bohr], the tabulated local
    pseudopotential with the Coulomb tail ADDED back (so the table is
    smooth), and the inferred ion charge."""
    values = []
    with open(path, "r") as fh:
        for line in fh:
            if "END COMMENT" in line:
                break
        fh.readline()  # the '3     5' version line
        k_max = float(fh.readline()) * RECPOT_BOHR
        for line in fh:
            parts = line.split()
            if len(parts) == 3:
                values += parts
    pot_ft = np.asarray(values, dtype=np.float64) * RECPOT_POT_CONV
    if pot_ft.size < 3:
        raise ValueError(f"recpot '{path}': too few tabulated values")
    ks, dk = np.linspace(0.0, k_max, pot_ft.size, retstep=True)
    # Z from the k->0 Coulomb limit V(k) - V(0) ~ -4 pi Z / k^2, anchored at
    # two small-k points so a malformed table raises
    z1 = (pot_ft[1] - pot_ft[0]) * dk * dk / (-4.0 * np.pi)
    z2 = (pot_ft[2] - pot_ft[0]) * (2.0 * dk) ** 2 / (-4.0 * np.pi)
    z = round(z1)
    if z < 0 or round(z2) != z or (z > 0 and abs(z1 - z) > 0.05 * z):
        raise ValueError(
            f"recpot '{path}': inconsistent k->0 Coulomb tail "
            f"(Z estimates {z1:.4f} and {z2:.4f}); file may be malformed")
    pot_ft = pot_ft.copy()
    pot_ft[1:] += 4.0 * np.pi * z / (ks[1:] * ks[1:])
    return ks, pot_ft, z


def get_ion_charge(path):
    """Ion charge Z from the k->0 limit -4 pi Z / k^2."""
    return read_recpot(path)[2]


def interpolate_recpot(path, ks_interp):
    """The recpot table of ``path`` Hermite-interpolated onto the
    wavenumbers ``ks_interp`` (clamped to the table's end), with the
    Coulomb tail -4 pi Z / k^2 subtracted analytically away from k = 0.
    Works in the dtype and on the device of ``ks_interp``."""
    ks, pot_ft, z = read_recpot(path)
    ks = torch.as_tensor(ks, dtype=ks_interp.dtype, device=ks_interp.device)
    pot_ft = torch.as_tensor(pot_ft, dtype=ks_interp.dtype,
                             device=ks_interp.device)
    interp = interpolate(ks, pot_ft, torch.clamp(ks_interp, max=ks[-1]))
    nz = ks_interp != 0.0
    k_safe = torch.where(nz, ks_interp, 1.0)
    return torch.where(nz, interp - 4.0 * np.pi * z / k_safe**2, interp)


def structure_factor(box_vecs, shape, cart_ion_coords):
    """Exact O(N_grid * N_ions) structure factor S(q) = sum_i e^{-i q.r_i}
    on the rfftn half-spectrum grid."""
    kx, ky, kz, _ = wavevecs(box_vecs, shape)
    kr = (kx[..., None] * cart_ion_coords[:, 0]
          + ky[..., None] * cart_ion_coords[:, 1]
          + kz[..., None] * cart_ion_coords[:, 2])
    return torch.complex(torch.cos(kr).sum(-1), -torch.sin(kr).sum(-1))


def lattice_sum(box_vecs, shape, cart_ion_coords, f_tilde, order=None):
    """F(r) = irfftn(S(q) f~(q)) / vol with the unscaled inverse transform
    (``norm="forward"``); S is the exact structure factor, or the PME one
    of B-spline ``order`` (even, >= 2).  Under ``pencil_mode`` ``shape``
    is the local slab's, and so is the result."""
    if order is None:
        S = structure_factor(box_vecs, shape, cart_ion_coords)
    else:
        if not (order % 2 == 0 and order >= 2):
            raise ValueError("PME requires an even order >= 2")
        S = structure_factor_spline(box_vecs, shape, cart_ion_coords, order)
    group = _grid._PENCIL
    if group is not None:
        from ..parallel import pfft
        from ..parallel.collectives import axis_size
        n_glob = shape[0] * axis_size(group) * shape[1] * shape[2]
        # norm="forward": the inverse transform is unscaled
        return (n_glob * pfft.pirfftn_dc(S * f_tilde, shape, group)
                / volume(box_vecs))
    return (torch.fft.irfftn(S * f_tilde, s=tuple(shape), norm="forward")
            / volume(box_vecs))


def cardinal_b_spline_values(x, order):
    """[M_n(x + i) for i = 0..n-1] for x in [0, 1), stacked on a new
    leading axis, by the recurrence M_n[i] = ((x+i) M_{n-1}[i] +
    (n-x-i) M_{n-1}[i-1]) / (n-1)."""
    if order < 2:
        raise ValueError("Requires order n >= 2")
    zeros = torch.zeros_like(x)
    M = [x, 1.0 - x] + [zeros] * (order - 2)
    for n in range(3, order + 1):
        new = [None] * order
        for i in range(n - 1, 0, -1):
            new[i] = ((x + i) * M[i] + (n - x - i) * M[i - 1]) / (n - 1)
        new[0] = x / (n - 1) * M[0]
        for i in range(n, order):
            new[i] = M[i]
        M = new
    return torch.stack(M)


def exponential_spline_b(m, N, order):
    """Exponential-spline deconvolution factors b(m) (complex)."""
    M = cardinal_b_spline_values(torch.zeros_like(m), order)  # (order, |m|)
    i = torch.arange(order, dtype=m.dtype, device=m.device)[:, None]
    b = torch.sum(M * expi(2.0 * np.pi * m * (i - 1.0) / N), dim=0)
    return expi(2.0 * np.pi * m * (order - 1.0) / N) / b


def _spread_scatter(shape, l0, l1, l2, M0, M1, M2):
    """Charge spreading: one ``index_add`` of the (order^3 x ions)
    stencil weights into the flattened grid (arrays are (order, ions))."""
    N0, N1, N2 = shape
    w = (M0[:, None, None, :] * M1[None, :, None, :] * M2[None, None, :, :])
    flat_idx = ((l0[:, None, None, :] * N1 + l1[None, :, None, :]) * N2
                + l2[None, None, :, :])
    Q = torch.zeros(N0 * N1 * N2, dtype=w.dtype, device=w.device)
    Q = Q.index_add(0, flat_idx.reshape(-1), w.reshape(-1))
    return Q.reshape(shape)


def _spread_scatter_slab(local_shape, l0_local, l1, l2, M0, M1, M2):
    """The charge spread of one rank's axis-0 slab: every rank runs the
    same (order^3 x ions) stencil over the whole coordinates and keeps the
    rows inside its slab (``l0_local`` in [0, N0/P)), as one masked
    ``index_add``: rows outside add zero weight at index 0.  No halo
    exchange; the backward is the matching masked gather."""
    N0, N1, N2 = local_shape
    w = (M0[:, None, None, :] * M1[None, :, None, :] * M2[None, None, :, :])
    l0b = l0_local[:, None, None, :]
    inside = (l0b >= 0) & (l0b < N0)
    flat_idx = ((l0b * N1 + l1[None, :, None, :]) * N2
                + l2[None, None, :, :])
    flat_idx = torch.where(inside, flat_idx, 0)
    w = torch.where(inside, w, 0.0)
    Q = torch.zeros(N0 * N1 * N2, dtype=w.dtype, device=w.device)
    Q = Q.index_add(0, flat_idx.reshape(-1), w.reshape(-1))
    return Q.reshape(local_shape)


def structure_factor_spline(box_vecs, shape, cart_ion_coords, order,
                            method="auto"):
    """Particle-mesh Ewald structure factor via cardinal B-splines on the
    rfftn half-spectrum grid: conj(B * rfftn(Q)), Q the spread charges.
    ``method`` 'auto', 'scatter' and 'mxu' all run the scatter.  Under
    ``pencil_mode`` ``shape`` is the local slab's: the spread is
    ``_spread_scatter_slab``, the transform the pencil rfftn, and the
    deconvolution factors are taken on this rank's k-pencil."""
    if method not in ("auto", "scatter", "mxu"):
        raise ValueError("method must be 'auto', 'scatter' or 'mxu'")
    group = _grid._PENCIL
    if group is not None:
        from ..parallel.collectives import axis_size, axis_index
        P, r = axis_size(group), axis_index(group)
    else:
        P, r = 1, 0
    N0, N1, N2 = shape
    gshape = (N0 * P, N1, N2)
    frac = cart_ion_coords @ inv3x3(box_vecs)
    # wrap into [0, 1) twice, so that -1e-16 -> 1.0 -> 0.0
    frac = frac - torch.floor(frac)
    frac = frac - torch.floor(frac)
    u = [frac[:, a] * n for a, n in enumerate(gshape)]
    f = [torch.floor(ua) for ua in u]
    M0, M1, M2 = (cardinal_b_spline_values(ua - fa, order)
                  for ua, fa in zip(u, f))            # (order, ions)
    orders = torch.arange(order, device=frac.device)[:, None]
    l0, l1, l2 = (torch.remainder(orders - fa.to(torch.long), n)
                  for fa, n in zip(f, gshape))
    if group is not None:
        Q = _spread_scatter_slab(shape, l0 - r * N0, l1, l2, M0, M1, M2)
    else:
        Q = _spread_scatter(shape, l0, l1, l2, M0, M1, M2)
    Q_ft = rfftn(Q)   # under pencil_mode: the k-pencil (N0 P, N1 / P, m2)

    def b(axis, n, start=0):
        m = torch.arange(start, start + Q_ft.shape[axis],
                         dtype=cart_ion_coords.dtype, device=frac.device)
        return exponential_spline_b(m, n, order)
    B = b(0, gshape[0])[:, None, None] \
        * b(1, N1, r * Q_ft.shape[1])[None, :, None] \
        * b(2, N2)[None, None, :]
    return torch.conj_physical(B * Q_ft)


def neighbor_shifts(box_vecs, Rc):
    """Static table of periodic-image shifts (lattice units) covering a
    sphere of radius Rc; host-side numpy from a concrete cell."""
    bv = np.asarray(box_vecs, dtype=np.float64)
    inv_T = np.linalg.inv(bv.T)
    h = 1.0 / np.sqrt(np.sum(inv_T**2, axis=1))
    n = np.ceil(float(Rc) / h).astype(int) + 1
    grids = np.meshgrid(*(np.arange(-ni, ni + 1) for ni in n), indexing="ij")
    shifts = np.stack([g.reshape(-1) for g in grids],
                      axis=1).astype(np.float64)
    # keep only images whose closest approach to the home cell can be < Rc
    centers = shifts @ bv
    diam = np.sqrt(3.0) * np.max(np.linalg.norm(bv, axis=1))
    keep = np.linalg.norm(centers, axis=1) <= float(Rc) + diam
    return shifts[keep]


def _pair_geometry(coords, box_vecs, s_chunk, Rc):
    """Displacements d[b, i, j] = R_j + s_b h - R_i of one image chunk, the
    pair mask (0 < r < Rc) and r where valid (1 elsewhere)."""
    disp = (coords[None, None, :, :]
            + (s_chunk @ box_vecs)[:, None, None, :]
            - coords[None, :, None, :])
    r = safe_sqrt(torch.sum(disp * disp, dim=-1))
    valid = (r < Rc) & (r > 1e-12)
    return disp, torch.where(valid, r, 1.0), valid


def _pair_energy_torch(coords, box_vecs, charges, shifts_t, Rc, Rd, chunk):
    """(sum of the pair terms Z_i Z_j erfc(r / Rd) / r over (i, j, b), the
    neighbour charges Q_i), image chunk by image chunk."""
    zz = charges[:, None] * charges[None, :]
    E = torch.zeros((), dtype=coords.dtype, device=coords.device)
    Q = torch.zeros(coords.shape[0], dtype=coords.dtype, device=coords.device)
    for s in range(0, shifts_t.shape[0], chunk):
        _, r, valid = _pair_geometry(coords, box_vecs, shifts_t[s:s + chunk],
                                     Rc)
        E = E + torch.sum(torch.where(
            valid, zz * torch.special.erfc(r / Rd) / r, 0.0))
        Q = Q + torch.sum(torch.where(valid, charges[None, None, :], 0.0),
                          dim=(0, 2))
    return E, Q


def _pair_grads_torch(coords, box_vecs, charges, shifts_t, Rc, Rd, chunk):
    """(dP/dR, dP/dh) of the pair-term sum P = sum_(i, j, b) e(|d_bij|),
    e(r) = Z_i Z_j erfc(r / Rd) / r, from e'(r) / r d chunk by chunk; any
    image table.  Differentiable where grad mode is on (a second
    derivative), holding each chunk's graph then."""
    zz = charges[:, None] * charges[None, :]
    c_exp = 2.0 / (float(np.sqrt(np.pi)) * Rd)
    gR = torch.zeros_like(coords)
    gh = torch.zeros_like(box_vecs)
    for s in range(0, shifts_t.shape[0], chunk):
        s_chunk = shifts_t[s:s + chunk]
        disp, r, valid = _pair_geometry(coords, box_vecs, s_chunk, Rc)
        x = r / Rd
        f = torch.where(valid, -zz * (c_exp * torch.exp(-x * x)
                                      + torch.special.erfc(x) / r) / (r * r),
                        0.0)
        G = f[..., None] * disp                     # dP/dd, (b, i, j, 3)
        gR = gR + torch.sum(G, dim=(0, 1)) - torch.sum(G, dim=(0, 2))
        gh = gh + s_chunk.T @ torch.sum(G, dim=(1, 2))
    return gR, gh


@functools.lru_cache(maxsize=None)
def _pair_library():
    """Compile ``csrc/ion_pairs.cu`` (once per source content) and load
    it."""
    lib = build("ion_pairs.cu")
    lib.ion_pair_sum.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 \
        + [ctypes.c_double] * 4 + [ctypes.c_void_p] * 4 \
        + [ctypes.c_int, ctypes.c_void_p]
    lib.ion_pair_sum.restype = ctypes.c_int
    lib.ion_pair_threads.restype = ctypes.c_int
    return lib


def _pair_launch(pos, z, tvec, Rc, Rd, grad):
    """One launch of the pair kernel on float64 CUDA tensors: its partial
    sums (e, q, g, w), laid out as ``csrc/ion_pairs.cu`` says (g and w
    only with ``grad``)."""
    lib = _pair_library()
    n, S = pos.shape[0], tvec.shape[0]
    nx = -(-n // lib.ion_pair_threads())
    sb = max(1, -(-nx * S // _PAIR_BLOCKS))     # shifts a block
    ny = -(-S // sb)
    e = torch.empty((ny, n), dtype=pos.dtype, device=pos.device)
    q = torch.empty_like(e)
    g = torch.empty((ny, n, 3), dtype=pos.dtype, device=pos.device) \
        if grad else None
    w = torch.empty((nx, S, 3), dtype=pos.dtype, device=pos.device) \
        if grad else None
    with torch.cuda.device(pos.device):
        err = lib.ion_pair_sum(
            pos.data_ptr(), z.data_ptr(), tvec.data_ptr(), n, S, sb,
            float(Rc), float(Rc) ** 2 * (1.0 + 1e-12), 1.0 / float(Rd),
            2.0 / (float(np.sqrt(np.pi)) * float(Rd)), e.data_ptr(),
            q.data_ptr(), g.data_ptr() if grad else None,
            w.data_ptr() if grad else None, int(grad),
            torch.cuda.current_stream(pos.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ion_pair_sum: CUDA launch failed (error {err})")
    return e, q, g, w


def _pair_sum_cuda(coords, box_vecs, charges, shifts_t, Rc, Rd, grad,
                   symmetric=None):
    """The pair kernel's (pair-term sum P, Q) and, with ``grad``, (dP/dR,
    dP/dh), in the dtypes of the inputs.  The gradient of an ion is met
    at both ends of its pairs: the launch sums the i ends; where the table
    is ``symmetric`` (-s beside every s, as ``neighbor_shifts`` gives) the
    j ends sum to the same, otherwise a second launch over the negated
    table gives them.  ``None`` reads the table back from the device to
    find out (a synchronisation)."""
    global pair_launches, pair_terms
    f64 = torch.float64
    shifts64 = shifts_t.to(f64)
    tvec = (shifts64 @ box_vecs.detach().to(f64)).contiguous()
    n, S = coords.shape[0], tvec.shape[0]
    pos = coords.detach().to(f64).contiguous()
    z = charges.detach().to(f64).contiguous()
    with annotate("ions.pair_sum"):
        e, q, g, w = _pair_launch(pos, z, tvec, Rc, Rd, grad)
        if grad and symmetric is None:
            symmetric = _symmetric(shifts64.cpu().numpy())
        g_far = g if not grad or symmetric else \
            _pair_launch(pos, z, -tvec, Rc, Rd, True)[2]
    launches = 1 if g_far is g else 2
    pair_launches += launches
    pair_terms += launches * n * n * S
    dt = coords.dtype
    P, Q = torch.sum(e).to(dt), torch.sum(q, dim=0).to(dt)
    if not grad:
        return P, Q, None, None
    gR = -torch.sum(g, dim=0) - torch.sum(g_far, dim=0)
    gh = shifts64.T @ torch.sum(w, dim=0)
    return P, Q, gR.to(dt), gh.to(box_vecs.dtype)


def _symmetric(shifts):
    """Whether the image table holds -s beside every s."""
    a = np.asarray(shifts, dtype=np.float64)
    return np.array_equal(a[np.lexsort(a.T[::-1])],
                          (-a)[np.lexsort((-a).T[::-1])])


class _IonPairSum(torch.autograd.Function):
    """(sum over pairs of Z_i Z_j erfc(r / Rd) / r, Q_i) with a backward
    that holds no graph across image chunks.  With ``kernel`` (CUDA
    tensors) the kernel computes the sum, and with ``with_grad`` the
    gradients too, in the forward (the backward scales them); otherwise
    the torch form sums chunk by chunk and the backward recomputes chunk
    by chunk.  Under ``create_graph`` the backward is the torch form with
    its graph, so second derivatives go through.  ``symmetric`` tells the
    kernel's wrapper whether the table holds -s beside every s (``None``:
    it reads the table back to see).  Q is piecewise constant: it has no
    gradient."""

    @staticmethod
    def forward(coords, box_vecs, charges, shifts_t, Rc, Rd, chunk, kernel,
                with_grad, symmetric=None):
        if kernel:
            return _pair_sum_cuda(coords, box_vecs, charges, shifts_t, Rc,
                                  Rd, with_grad, symmetric)
        with annotate("ions.pair_sum"):
            P, Q = _pair_energy_torch(coords, box_vecs, charges, shifts_t,
                                      Rc, Rd, chunk)
        return P, Q, None, None

    @staticmethod
    def setup_context(ctx, inputs, output):
        coords, box_vecs, charges, shifts_t, Rc, Rd, chunk = inputs[:7]
        ctx.save_for_backward(coords, box_vecs, charges, shifts_t)
        ctx.args = (Rc, Rd, chunk)
        ctx.grads = output[2:] if output[2] is not None else None
        ctx.mark_non_differentiable(*(t for t in output[1:]
                                      if t is not None))

    @staticmethod
    def backward(ctx, gE, *_):
        coords, box_vecs, charges, shifts_t = ctx.saved_tensors
        if ctx.grads is not None and not torch.is_grad_enabled():
            gR, gh = ctx.grads
        else:
            with annotate("ions.pair_sum"):
                gR, gh = _pair_grads_torch(coords, box_vecs, charges,
                                           shifts_t, *ctx.args)
        need = ctx.needs_input_grad
        return (gE * gR if need[0] else None, gE * gh if need[1] else None,
                None, None, None, None, None, None, None, None)


def ion_interaction_sum(box_vecs, coords, charges, Rc, Rd, shifts=None,
                        chunk=None):
    """Real-space damped pairwise electrostatic sum in a neutralising
    background (Witt et al., PRMaterials 2, 013806):

    E = 1/2 sum_{i != j, |r_ij| < Rc} Z_i Z_j erfc(r_ij / Rd) / r_ij
        + per-ion adaptive-radius correction terms.

    ``shifts`` (lattice-unit image table) defaults to
    :func:`neighbor_shifts` of the concrete cell.  For CUDA tensors the
    pair sum is the kernel of ``csrc/ion_pairs.cu`` (one launch, or two
    for the gradients of a table without -s beside some s); for CPU
    tensors the images are summed ``chunk`` at a time (bounded memory);
    ``None`` picks the most that keep a chunk within ``_MAX_PAIRS`` pair
    terms.  Either way no graph is kept across chunks.  Differentiable with respect to
    ``coords`` and ``box_vecs``, twice."""
    if shifts is None:
        shifts = neighbor_shifts(box_vecs.detach().cpu().numpy(), Rc)
    n_ions = coords.shape[0]
    dtype, device = coords.dtype, coords.device
    shifts = np.asarray(shifts)
    shifts_t = torch.as_tensor(shifts, dtype=dtype, device=device)
    if chunk is None:
        chunk = max(1, _MAX_PAIRS // (n_ions * n_ions))
    kernel = device.type == "cuda"
    with_grad = torch.is_grad_enabled() and (coords.requires_grad
                                             or box_vecs.requires_grad)
    pair_sum, Qi, _, _ = _IonPairSum.apply(
        coords, box_vecs, charges, shifts_t, Rc, Rd, chunk, kernel,
        with_grad, _symmetric(shifts) if kernel and with_grad else None)
    E_local = 0.5 * pair_sum

    rho = torch.sum(charges) / volume(box_vecs)
    aux = (0.75 / np.pi) * Qi / rho
    Ra = torch.sign(aux) * torch.abs(aux) ** (1.0 / 3.0)
    sqrt_pi = float(np.sqrt(np.pi))
    E_corr = torch.sum(
        -np.pi * charges * rho * Ra**2
        + np.pi * charges * rho * (Ra**2 - 0.5 * Rd * Rd)
        * torch.special.erf(Ra / Rd)
        + sqrt_pi * charges * rho * Ra * Rd * torch.exp(-Ra**2 / Rd**2)
        - charges**2 / sqrt_pi / Rd)
    return E_local + E_corr
