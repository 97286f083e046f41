"""Plain PyTorch reference of the orbital-free DFT that the benchmark runs.

It judges the program's answers and imports nothing of the program: only
``torch``, ``numpy`` and ``scipy``.  Every function works in the dtype and
on the device of its inputs, and takes an optional leading lane axis on
fields (``(..., n0, n1, n2)``) and cells (``(..., 3, 3)``), so that the
volumes of an EOS scan run as lanes of one solve.  Units are atomic
(bohr, Hartree) unless a name says otherwise.

What it computes, each written out from the physics:

- the local pseudopotential of a CASTEP ``.recpot`` table, cubic-Hermite
  interpolated onto |k| with the Coulomb tail taken out and put back
  analytically, the exact structure factor (blocks of ions) and v_ext;
- the energy terms: ion-electron, Hartree, Thomas-Fermi, von Weizsaecker,
  the Wang-Teter non-local term, WT (alpha = beta = 5/6), the WT-style
  functional with an exponential stabiliser, PBE exchange-correlation, and
  the damped real-space ion-ion sum with its neutralising-background
  correction (Witt et al., Phys. Rev. Materials 2, 013806);
- the functional derivative and the Euler residual of a density, the
  Hellmann-Feynman forces (ions in blocks, image shifts in chunks);
- a ground-state solver (preconditioned Barzilai-Borwein steps on
  chi = sqrt(n)), and the Birch-Murnaghan fit of an EOS scan.

``quant``: a rounding applied to every field the energy produces (the
density it starts from, each integrand, each transform's output).  The
identity by default; ``to_bf16`` rounds to bfloat16 and back, which is how
the lower-precision control stores its fields while its arithmetic and
sums stay in float32.
"""

import numpy as np
import torch

A_PER_BOHR = 0.529177210903
EV_PER_HA = 4.3597447222071e-18 / 1.602176634e-19
GPA_PER_EV_A3 = 160.21766208
# the recpot format's own (older) constants
_RECPOT_BOHR = 0.529177208607388
_RECPOT_HA_EV = 27.2113834279111
C_TF = 0.3 * (3.0 * np.pi ** 2) ** (2.0 / 3.0)


def identity(x):
    return x


def to_bf16(x):
    """Round a real field to bfloat16 and back (its storage precision)."""
    return x.to(torch.bfloat16).to(x.dtype)


class _Stored(torch.autograd.Function):
    """A field stored through ``quant`` on the way forward, and its
    gradient stored the same way on the way back."""

    @staticmethod
    def forward(ctx, x, quant):
        ctx.quant = quant
        return quant(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.quant(g), None


def stored(x, quant):
    if quant is identity:
        return x
    if torch.is_complex(x):
        return torch.complex(_Stored.apply(x.real, quant),
                             _Stored.apply(x.imag, quant))
    return _Stored.apply(x, quant)


# ----------------------------------------------------------------------
# pseudopotential, grid, structure factor
# ----------------------------------------------------------------------

def read_recpot(path):
    """(ks [1/bohr], V(k) [Ha bohr^3] with the Coulomb tail added back so
    the table is smooth, Z)."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    i = next(j for j, ln in enumerate(lines) if "END COMMENT" in ln)
    k_max = float(lines[i + 2]) * _RECPOT_BOHR
    vals = [float(v) for ln in lines[i + 3:] for v in ln.split()
            if len(ln.split()) == 3]
    pot = np.asarray(vals) / (_RECPOT_BOHR ** 3 * _RECPOT_HA_EV)
    ks = np.linspace(0.0, k_max, pot.size)
    z = round((pot[1] - pot[0]) * ks[1] ** 2 / (-4.0 * np.pi))
    pot[1:] = pot[1:] + 4.0 * np.pi * z / ks[1:] ** 2
    return ks, pot, z


def hermite(ks, vs, q):
    """Cubic Hermite interpolation of the uniform table vs(ks) at q, with
    secant tangents averaged at inner knots; q is clamped to the table."""
    ks = torch.as_tensor(ks, dtype=q.dtype, device=q.device)
    vs = torch.as_tensor(vs, dtype=q.dtype, device=q.device)
    sec = (vs[1:] - vs[:-1]) / (ks[1:] - ks[:-1])
    m = torch.cat([sec[:1], 0.5 * (sec[1:] + sec[:-1]), sec[-1:]])
    q = torch.clamp(q, max=float(ks[-1]))
    h = float(ks[1] - ks[0])
    i = torch.clamp(torch.floor(q / h).long(), 0, ks.numel() - 2)
    t = (q - ks[i]) / h
    t2, t3 = t * t, t * t * t
    return ((1 - 3 * t2 + 2 * t3) * vs[i] + (t - 2 * t2 + t3) * m[i] * h
            + (3 * t2 - 2 * t3) * vs[i + 1] + (t3 - t2) * m[i + 1] * h)


def local_pseudopotential(table, k):
    """V(|k|) of one species on the half spectrum, k = 0 the table's own
    (finite) value, elsewhere the interpolated table minus 4 pi Z / k^2."""
    ks, vs, z = table
    v = hermite(ks, vs, k)
    nz = k > 0
    return torch.where(nz, v - 4.0 * np.pi * z / torch.where(nz, k, 1.0) ** 2,
                       v)


def volume(box):
    return torch.abs(torch.linalg.det(box))


def freqs(shape, dtype, device):
    """Integer frequencies of the rfftn layout, the Nyquist index of a
    full axis taken as +n/2."""
    def full(n):
        j = torch.arange(n, dtype=dtype, device=device)
        return torch.where(j <= n // 2, j, j - n)
    n0, n1, n2 = shape
    return (full(n0)[:, None, None], full(n1)[None, :, None],
            torch.arange(n2 // 2 + 1, dtype=dtype, device=device)[None, None])


def kvecs(box, shape):
    """kx, ky, kz, k2 on the half spectrum, (..., n0, n1, n2 // 2 + 1)."""
    rec = 2.0 * np.pi * torch.linalg.inv(box).transpose(-1, -2)
    f = freqs(shape, box.dtype, box.device)
    lead = box.shape[:-2]
    r = rec.reshape(lead + (1, 1, 1, 3, 3))
    k = [f[0] * r[..., 0, c] + f[1] * r[..., 1, c] + f[2] * r[..., 2, c]
         for c in range(3)]
    return k[0], k[1], k[2], k[0] ** 2 + k[1] ** 2 + k[2] ** 2


def rfft(x):
    return torch.fft.rfftn(x, dim=(-3, -2, -1))


def irfft(X, shape):
    return torch.fft.irfftn(X, s=tuple(shape), dim=(-3, -2, -1))


def mean3(x):
    return torch.mean(x, dim=(-3, -2, -1))


def structure_factor(frac, shape, block=32):
    """Exact S(m) = sum_j exp(-2 pi i m . f_j) on the half spectrum, for
    fractional coordinates f (n_ions, 3), summed over blocks of ions.  It
    depends on the cell only through f, so one S serves every volume of a
    scan."""
    f = freqs(shape, frac.dtype, frac.device)
    S = None
    for s in range(0, frac.shape[0], block):
        fb = frac[s:s + block]
        ph = 2.0 * np.pi * (f[0][..., None] * fb[:, 0] + f[1][..., None]
                            * fb[:, 1] + f[2][..., None] * fb[:, 2])
        part = torch.complex(torch.cos(ph).sum(-1), -torch.sin(ph).sum(-1))
        S = part if S is None else S + part
    return S


def v_ext(box, shape, S, table):
    """v_ext(r) = irfftn(S V(|k|)) / vol with the unscaled inverse."""
    _, _, _, k2 = kvecs(box, shape)
    Vk = local_pseudopotential(table, torch.sqrt(k2))
    n_pts = shape[0] * shape[1] * shape[2]
    vol = volume(box)[..., None, None, None]
    return irfft(S * Vk, shape) * (n_pts / vol)


# ----------------------------------------------------------------------
# energy terms: E(box, den) with den (..., n0, n1, n2)
# ----------------------------------------------------------------------

def _vol(box):
    return volume(box)


def ion_electron(box, den, vext, quant=identity):
    return mean3(quant(den * vext)) * _vol(box)


def hartree(box, den, quant=identity):
    _, _, _, k2 = kvecs(box, den.shape[-3:])
    nz = k2 > 0
    coul = torch.where(nz, 4.0 * np.pi / torch.where(nz, k2, 1.0), 0.0)
    pot = quant(irfft(rfft(den) * coul, den.shape[-3:]))
    return 0.5 * mean3(quant(den * pot)) * _vol(box)


def thomas_fermi(box, den, quant=identity):
    return C_TF * mean3(quant(den ** (5.0 / 3.0))) * _vol(box)


def weizsaecker(box, den, quant=identity):
    """1/8 int |grad n|^2 / n in Laplacian form, 1/4 lap n - 1/2 sqrt(n)
    lap sqrt(n) (the first integrates to zero on a periodic grid)."""
    _, _, _, k2 = kvecs(box, den.shape[-3:])
    sq = torch.sqrt(den)
    lap = quant(irfft(-k2 * rfft(sq), den.shape[-3:]))
    return mean3(quant(-0.5 * sq * lap)) * _vol(box)


def lindhard_inverse(eta):
    """1 / Lindhard response, patched at eta = 0 and 1; above eta = 10
    its large-eta series (the closed form cancels there)."""
    sing = (eta == 0) | (eta == 1)
    e = torch.where(sing, 0.5, eta)
    closed = 0.5 + (1 - e * e) / (4 * e) * torch.log(torch.abs((1 + e)
                                                                / (1 - e)))
    u = 1.0 / torch.where(eta > 10, eta, 10.0) ** 2
    series = sum(u ** k / ((2 * k - 1) * (2 * k + 1)) for k in range(1, 9))
    val = torch.where(eta > 10, series, closed)
    val = torch.where(eta == 0, 1.0, val)
    return torch.where(eta == 1, 0.5, val)


def wt_nonlocal(box, den, alpha=5.0 / 6.0, beta=5.0 / 6.0, quant=identity):
    """C_TF int (n^a - n0^a) K * (n^b - n0^b) with the Wang-Teter kernel
    about the mean density n0 (the electron count held constant)."""
    vol = _vol(box)
    n0 = (mean3(den).detach())[..., None, None, None]
    _, _, _, k2 = kvecs(box, den.shape[-3:])
    kF = (3.0 * np.pi ** 2 * n0) ** (1.0 / 3.0)
    eta = torch.sqrt(k2) / (2.0 * kF)
    kern = (5.0 / (9.0 * alpha * beta * n0 ** (alpha + beta - 5.0 / 3.0))
            * (1.0 / lindhard_inverse(eta) - 3.0 * eta * eta - 1.0))
    conv = quant(irfft(kern * rfft(quant(den ** beta - n0 ** beta)),
                       den.shape[-3:]))
    return C_TF * mean3(quant((den ** alpha - n0 ** alpha) * conv)) * vol


def wang_teter(box, den, quant=identity):
    return (weizsaecker(box, den, quant) + thomas_fermi(box, den, quant)
            + wt_nonlocal(box, den, quant=quant))


def smargiassi_madden(box, den, quant=identity):
    return (weizsaecker(box, den, quant) + thomas_fermi(box, den, quant)
            + wt_nonlocal(box, den, 0.5, 0.5, quant))


def wang_teter_exp(box, den, quant=identity):
    """vW + TF exp(T_NL / TF): the WT-style functional with f = exp
    (f(0) = f'(0) = 1)."""
    tf = thomas_fermi(box, den, quant)
    return (weizsaecker(box, den, quant)
            + tf * torch.exp(wt_nonlocal(box, den, quant=quant) / tf))


def _grad_sq(box, den, quant):
    kx, ky, kz, _ = kvecs(box, den.shape[-3:])
    F = rfft(den)
    g2 = 0
    for k in (kx, ky, kz):
        g = quant(irfft(torch.complex(-k * F.imag, k * F.real),
                        den.shape[-3:]))
        g2 = g2 + g * g
    return g2


def pbe(box, den, quant=identity):
    """PBE exchange and correlation (PW92 correlation under the gradient
    correction H)."""
    g2 = _grad_sq(box, den, quant)
    ex = -(0.75) * (3.0 / np.pi) ** (1.0 / 3.0) * den ** (4.0 / 3.0)
    s2 = 0.25 * (3.0 * np.pi ** 2) ** (-2.0 / 3.0) * g2 * den ** (-8.0 / 3.0)
    kappa, mu = 0.804, 0.066725 * np.pi ** 2 / 3.0
    fx = 1.0 + kappa - kappa / (1.0 + mu / kappa * s2)
    rs = (3.0 / (4.0 * np.pi) / den) ** (1.0 / 3.0)
    A_, al = 0.0310907, 0.2137
    b1, b2, b3, b4 = 7.5957, 3.5876, 1.6382, 0.49294
    srs = torch.sqrt(rs)
    zeta = 2 * A_ * (b1 * srs + b2 * rs + b3 * rs * srs + b4 * rs * rs)
    ec = -2 * A_ * (1 + al * rs) * torch.log(1 + 1 / zeta)
    beta = 0.066725
    gam = (1.0 - np.log(2.0)) / np.pi ** 2
    A = beta / gam / (torch.exp(-ec / gam) - 1.0 + 1e-30)
    t2 = (np.pi / 3.0) ** (1.0 / 3.0) / 16.0 * g2 / (den ** (7.0 / 3.0)
                                                     + 1e-30)
    At2 = A * t2
    H = gam * torch.log(1 + beta / gam * t2 * (1 + At2)
                        / (1 + At2 + At2 * At2))
    return mean3(quant(fx * ex + (ec + H) * den)) * _vol(box)


KINETIC = {"WangTeter": wang_teter, "WangTeterExp": wang_teter_exp,
           "SmargiassiMadden": smargiassi_madden}
XC = {"PBE": pbe}


def density_terms(terms, box, den, vext, quant=identity):
    """Energy [Ha] of every term but the ion-ion one, per lane."""
    E = 0
    for t in terms:
        if t == "IonIon":
            continue
        if t == "IonElectron":
            E = E + ion_electron(box, den, vext, quant)
        elif t == "Hartree":
            E = E + hartree(box, den, quant)
        elif t in KINETIC:
            E = E + KINETIC[t](box, den, quant)
        elif t in XC:
            E = E + XC[t](box, den, quant)
        else:
            raise ValueError(f"reference: no term {t!r}")
    return E


# ----------------------------------------------------------------------
# ion-ion
# ----------------------------------------------------------------------

def cell_heights(box):
    """Distances between opposite faces of a cell (3, 3) [bohr]."""
    inv_t = np.linalg.inv(np.asarray(box, dtype=np.float64).T)
    return 1.0 / np.sqrt(np.sum(inv_t ** 2, axis=1))


def image_shifts(box, rc):
    """Every lattice translation whose image of the cell can hold a point
    within rc of the home cell."""
    box = np.asarray(box, dtype=np.float64)
    n = np.ceil(rc / cell_heights(box)).astype(int) + 1
    g = np.stack(np.meshgrid(*(np.arange(-m, m + 1) for m in n),
                             indexing="ij"), -1).reshape(-1, 3)
    diam = np.sqrt(3.0) * np.max(np.linalg.norm(box, axis=1))
    keep = np.linalg.norm(g @ box, axis=1) <= rc + diam
    return g[keep].astype(np.float64)


def ion_ion(box, cart, charges, rc, forces=False, pairs=1 << 22):
    """Damped real-space ion-ion energy [Ha] with its background
    correction; the damping length rd = sqrt(h_max rc / 3).  With
    ``forces`` also -dE/dR (the neighbour counts are piecewise constant,
    so the forces come from the pair sum alone), chunk by chunk."""
    h = cell_heights(box.detach().cpu().numpy())
    rd = float(np.sqrt(np.max(h) * rc / 3.0))
    shifts = torch.as_tensor(image_shifts(box.detach().cpu().numpy(), rc),
                             dtype=box.dtype, device=box.device)
    n = cart.shape[0]
    zz = charges[:, None] * charges[None, :]
    step = max(1, pairs // (n * n))
    E = torch.zeros((), dtype=box.dtype, device=box.device)
    Q = torch.zeros(n, dtype=box.dtype, device=box.device)
    F = torch.zeros_like(cart)
    for s in range(0, shifts.shape[0], step):
        with torch.enable_grad():
            R = cart.detach().requires_grad_(forces)
            d = (R[None, None, :, :] + (shifts[s:s + step] @ box)[:, None,
                                                                   None, :]
                 - R[None, :, None, :])
            r2 = torch.sum(d * d, -1)
            ok = (r2 < rc * rc) & (r2 > 1e-24)
            r = torch.sqrt(torch.where(ok, r2, 1.0))
            e = 0.5 * torch.sum(torch.where(
                ok, zz * torch.special.erfc(r / rd) / r, 0.0))
            if forces:
                (g,) = torch.autograd.grad(e, R)
                F = F - g
        E = E + e.detach()
        Q = Q + torch.sum(torch.where(ok, charges[None, None, :], 0.0),
                          dim=(0, 2))
    rho = torch.sum(charges) / volume(box)
    ra = (0.75 / np.pi * Q / rho) ** (1.0 / 3.0)
    sp = float(np.sqrt(np.pi))
    E = E + torch.sum(
        -np.pi * charges * rho * ra ** 2
        + np.pi * charges * rho * (ra ** 2 - 0.5 * rd * rd)
        * torch.special.erf(ra / rd)
        + sp * charges * rho * ra * rd * torch.exp(-ra ** 2 / rd ** 2)
        - charges ** 2 / sp / rd)
    return (E, F) if forces else E


# ----------------------------------------------------------------------
# derivatives of the density terms, forces
# ----------------------------------------------------------------------

def potential(terms, box, den, vext):
    """dE/dn [Ha] of the density terms (per unit volume)."""
    with torch.enable_grad():
        n = den.detach().requires_grad_(True)
        E = density_terms(terms, box, n, vext)
        (g,) = torch.autograd.grad(E.sum(), n)
    dv = (volume(box) / np.prod(den.shape[-3:]))[..., None, None, None]
    return g / dv


def euler_rms(terms, box, den, vext):
    """Density-weighted RMS of dE/dn - mu [Ha], mu = <n dE/dn> / <n>: zero
    at a ground state."""
    v = potential(terms, box, den, vext)
    mu = mean3(den * v) / mean3(den)
    r = v - mu[..., None, None, None]
    return torch.sqrt(mean3(den * r * r) / mean3(den))


def electron_ion_forces(box, den, frac, table, block=16, quant=identity):
    """-dU_ie/dR at a fixed density with the exact structure factor,
    blocks of ions at a time [Ha/bohr]; with ``quant`` every field of the
    pass (structure factor, potential, density) and its gradient is
    stored through it."""
    shape = den.shape[-3:]
    _, _, _, k2 = kvecs(box, shape)
    Vk = local_pseudopotential(table, torch.sqrt(k2))
    f = freqs(shape, box.dtype, box.device)
    n_pts = shape[0] * shape[1] * shape[2]
    vol = volume(box)
    inv = torch.linalg.inv(box)
    cart = frac @ box
    out = []
    for s in range(0, frac.shape[0], block):
        with torch.enable_grad():
            R = cart[s:s + block].detach().requires_grad_(True)
            fb = R @ inv
            ph = 2.0 * np.pi * (f[0][..., None] * fb[:, 0] + f[1][..., None]
                                * fb[:, 1] + f[2][..., None] * fb[:, 2])
            Sb = stored(torch.complex(torch.cos(ph).sum(-1),
                                      -torch.sin(ph).sum(-1)), quant)
            v = stored(irfft(Sb * Vk, shape) * (n_pts / vol), quant)
            U = torch.mean(stored(den, quant) * v) * vol
            (g,) = torch.autograd.grad(U, R)
        out.append(-g)
    return torch.cat(out)


# ----------------------------------------------------------------------
# ground state and EOS fit
# ----------------------------------------------------------------------

def precond_kernel(terms, box, shape, n_elec):
    """1 / F(k), F the Hessian of the density terms at the uniform density
    (translation invariant, so one Hessian-vector product against a delta
    gives its diagonal), floored at 1e-8 of its largest value."""
    vol = volume(box)[..., None, None, None]
    n0 = (n_elec / vol) * torch.ones(box.shape[:-2] + tuple(shape),
                                     dtype=box.dtype, device=box.device)
    delta = torch.zeros_like(n0)
    delta[..., 0, 0, 0] = 1.0
    zero = torch.zeros_like(n0)
    with torch.enable_grad():
        n = n0.requires_grad_(True)
        (g,) = torch.autograd.grad(density_terms(terms, box, n, zero).sum(),
                                   n, create_graph=True)
        (hv,) = torch.autograd.grad(g, n, grad_outputs=delta)
    F = rfft(hv).real
    fmax = torch.amax(F, dim=(-3, -2, -1), keepdim=True)
    return (1.0 / torch.maximum(F, 1e-8 * fmax)).detach()


def ground_state(terms, box, vext, n_elec, dtype=torch.float64,
                 quant=identity, ntol=1e-10, max_iter=2000, min_iter=5):
    """Minimise the density terms over n = N chi^2 / int chi^2 from the
    uniform density: preconditioned gradient steps, Barzilai-Borwein
    (s.y / y.My) after the first, in ``dtype`` with every stored field
    passed through ``quant``.  Lanes stop together once every lane's |dE|
    [Ha] has stayed below ``ntol`` three times in a row (after
    ``min_iter``).  Returns (den (float64), E [Ha] per lane as evaluated
    at the end point in ``dtype``, iterations, converged)."""
    box = box.to(dtype)
    vext = quant(vext.to(dtype))
    shape = vext.shape[-3:]
    M = quant(precond_kernel(terms, box, shape, n_elec).to(dtype))
    vol = volume(box)[..., None, None, None]

    def den_of(chi):
        return n_elec * chi * chi / (mean3(chi * chi)[..., None, None, None]
                                     * vol)

    def value_grad(chi):
        with torch.enable_grad():
            x = chi.detach().requires_grad_(True)
            E = density_terms(terms, box, quant(den_of(x)), vext, quant)
            (g,) = torch.autograd.grad(E.sum(), x)
        return E.detach(), quant(g)

    def prec(g):
        return quant(irfft(M * rfft(g), shape))

    def dot(a, b):
        return torch.sum(a * b, dim=(-3, -2, -1))

    lanes = box.shape[:-2]
    chi = torch.sqrt(n_elec / vol).expand(lanes + tuple(shape)).to(dtype)
    E, g = value_grad(chi)
    alpha = torch.ones(lanes, dtype=dtype, device=box.device)
    count = torch.zeros(lanes, dtype=torch.long, device=box.device)
    it = 0
    for it in range(1, max_iter + 1):
        p = prec(g)
        for _ in range(40):   # the first step backtracks until E falls
            chi_new = quant(chi - alpha[..., None, None, None] * p)
            E_new, g_new = value_grad(chi_new)
            if it > 1 or bool(torch.all(E_new <= E)):
                break
            alpha = torch.where(E_new <= E, alpha, 0.5 * alpha)
        s, y = chi_new - chi, g_new - g
        sy, yMy = dot(s, y), dot(y, prec(y))
        ok = (sy > 0) & (yMy > 0)
        alpha = torch.where(ok, sy / torch.where(ok, yMy, 1.0), alpha)
        dE = torch.abs(E_new - E)
        chi, E, g = chi_new, E_new, g_new
        count = torch.where(dE < ntol, count + 1, 0)
        if it >= min_iter and bool(torch.all(count >= 3)):
            break
    conv = bool(torch.all(count >= 3))
    return den_of(chi).to(torch.float64), E, it, conv


def birch_murnaghan(v, e):
    """(K0 [GPa], K0', E0 [eV/atom], V0 [A^3/atom]) fitted to volumes
    [A^3/atom] and energies [eV/atom]."""
    from scipy.optimize import curve_fit
    v, e = np.asarray(v, dtype=np.float64), np.asarray(e, dtype=np.float64)
    a, b, c = np.polyfit(v, e, 2)
    v0 = -b / (2 * a)
    k0 = 2 * a * v0

    def bm(x, K0, K0p, E0, V0):
        t = (V0 / x) ** (2.0 / 3.0) - 1.0
        return E0 + 9 * V0 * K0 / 16 * (K0p * t ** 3 + t ** 2 * (6 - 4 * (
            V0 / x) ** (2.0 / 3.0)))

    p, _ = curve_fit(bm, v, e, p0=(k0, 3.5, float(np.polyval((a, b, c), v0)),
                                   v0), maxfev=10000)
    return float(p[0]) * GPA_PER_EV_A3, float(p[1]), float(p[2]), float(p[3])
