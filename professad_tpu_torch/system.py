"""The System class: orbital-free DFT with periodic boundaries (PyTorch).

Port of the ``professad_tpu.system.System`` subset for the density
optimization and its first derivatives: setup (cell, ions, recpot
interpolation, v_ext), the energy assembly, the chi gradient (fused
analytic, or autograd of the energy), the exact uniform-density
preconditioner, the L-BFGS and TPGD density optimizers with the
``dE`` / ``dEdchi`` / ``euler`` stopping rules, the convergence
diagnostics, and the Hellmann-Feynman forces and the stress by autograd.

Precision: the state (cell, ion coordinates, density, v_ext) is held in
float64 on ``device`` (``None`` means ``cuda:0``; pass ``device="cpu"`` for
the CPU); ``dtype`` is the working dtype of the density optimization
(float32 is the fast tier, float64 the correctness tier; the L-BFGS paths
are held to the JAX package in float64 only).  After an optimization the
stored energy is the solver's own energy at the returned iterate
(evaluated in ``dtype`` with f64 accumulation) plus the ion-ion energy,
and the density is stored back in float64.
"""

import functools

import numpy as np
import torch

from .ops.grid import (wavevecs, volume, safe_sqrt, inv3x3, rfftn, wmean,
                       spectral_convolution)
from .ops.interp import interpolate
from .ops import solvers
from .ops.autodiff import get_functional_derivative
from .models import ions as ion_utils
from .models.interaction import IonElectron
from .utils.constants import A_PER_B, EV_PER_HA, GPA_PER_ATOMIC
from .utils.naming import term_name
from .utils.device import resolve_device

__all__ = ["System"]

_F64 = torch.float64


class System:
    """A periodic system for orbital-free DFT calculations.

    ``device`` / ``dtype``: where the state lives (``None`` means
    ``cuda:0`` and raises without a CUDA device), and the working dtype of
    ``optimize_density`` (see the module docstring)."""

    A_per_b = A_PER_B
    eV_per_Ha = EV_PER_HA
    GPa_per_atomic = GPA_PER_ATOMIC

    def __init__(self, box_vecs, shape, ions, terms, units="b",
                 coord_type="cartesian", Rc=None, pme_order=None,
                 device=None, dtype=torch.float64):
        if pme_order is not None:
            raise NotImplementedError(
                "particle-mesh Ewald (pme_order) is not ported yet: "
                "ROADMAP A8")
        if dtype not in (torch.float32, torch.float64):
            raise ValueError("dtype must be torch.float32 or torch.float64")
        self._terms = list(terms)
        self._shape = tuple(int(s) for s in shape)
        self._Rc = Rc
        self._device = resolve_device(device)
        self._dtype = dtype
        self._Eion_cache = None
        self._shifts = None
        self._shifts_key = None

        self.set_lattice(box_vecs, units, initialization=True)
        self._process_ions(ions, coord_type, units)
        self._update_ionic_potential()
        self.initialize_density()

    def _t(self, a):
        return torch.as_tensor(a, dtype=_F64, device=self._device)

    # ------------------------------------------------------------------
    # setup / state updates
    # ------------------------------------------------------------------

    @classmethod
    def ecut2shape(cls, energy_cutoff, box_vecs):
        """Grid shape from a plane-wave cutoff in eV."""
        bvs = np.asarray(box_vecs, dtype=np.float64) / cls.A_per_b
        ecut = energy_cutoff / cls.eV_per_Ha
        kcut = np.sqrt(2.0 * ecut)
        lens = np.sqrt(np.sum(bvs**2, axis=1))
        shape = 1 + 2 * np.ceil(kcut / (2.0 * np.pi / lens))
        return tuple(int(s) for s in shape)

    def _process_ions(self, ions, coord_type, units):
        N_elec, ion_list, coords = 0, [], []
        self._recpot_tables = []
        for species in ions:
            ks, pot_ft, charge = ion_utils.read_recpot(species[1])
            self._recpot_tables.append((self._t(ks), self._t(pot_ft), charge))
            c = torch.as_tensor(species[2], dtype=_F64).cpu().numpy()
            count = int(c.shape[0])
            ion_list.append((species[0], species[1], count, charge))
            coords.append(c)
            N_elec += count * charge
        ion_coords = np.concatenate(coords, axis=0)
        self._N_ions = int(ion_coords.shape[0])
        self._N_elec = N_elec
        self._ions = ion_list
        charges = np.concatenate([np.full(c, z, dtype=np.float64)
                                  for (_, _, c, z) in ion_list])
        self._charges = self._t(charges)
        self.place_ions(ion_coords, coord_type, units, initialization=True)

    def place_ions(self, ion_coords, coord_type="cartesian", units="a",
                   initialization=False):
        """Place ions, wrapping fractional coordinates into [0, 1)."""
        ion_coords = self._t(ion_coords)
        if coord_type == "cartesian":
            ion_coords = ion_coords / self._unit_factor(units)
            frac = ion_coords @ inv3x3(self._box_vecs)
        elif coord_type == "fractional":
            frac = ion_coords
        else:
            raise ValueError("coord_type must be 'cartesian' or 'fractional'")
        # double-wrap: tiny negatives map -1e-16 -> 1.0 -> 0.0
        frac = frac - torch.floor(frac)
        frac = frac - torch.floor(frac)
        self._frac_ion_coords = frac
        if not initialization:
            self._update_ionic_potential()
            self._ene = self._compute_energy()

    @staticmethod
    def _unit_factor(units):
        if units == "a":
            return System.A_per_b
        if units == "b":
            return 1.0
        raise ValueError("units must be 'b' (Bohr) or 'a' (Angstrom)")

    def set_lattice(self, box_vecs, units="a", initialization=False):
        """Set lattice vectors; rescales the density to preserve N."""
        box = (torch.as_tensor(box_vecs, dtype=_F64).cpu().numpy()
               / self._unit_factor(units))
        det = np.linalg.det(box)
        scale = float(np.prod(np.sqrt(np.sum(box * box, axis=1))))
        if not np.isfinite(det) or abs(det) <= 1e-12 * max(scale, 1e-300):
            raise ValueError(f"singular or near-singular cell (det={det:.3e})")
        if not initialization:
            old_vol = self.volume("b3")
        self._box_vecs = self._t(box)
        self._shifts_key = None
        if not initialization:
            self._update_ionic_potential()
            self._den = self._den * old_vol / self.volume("b3")
            self._ene = self._compute_energy()

    # -- ionic potential ----------------------------------------------------

    def _interp_recpot(self, table, ks_interp):
        ks, pot_ft, z = table
        ks = ks.to(ks_interp.dtype)
        pot_ft = pot_ft.to(ks_interp.dtype)
        interp = interpolate(ks, pot_ft, torch.clamp(ks_interp, max=ks[-1]))
        nz = ks_interp != 0.0
        k_safe = torch.where(nz, ks_interp, 1.0)
        return torch.where(nz, interp - 4.0 * np.pi * z / k_safe**2, interp)

    def _potential_from_ions(self, box_vecs, cart_ion_coords):
        """v_ext(r) from the recpot tables; differentiable with respect to
        (box_vecs, cart_ion_coords)."""
        shape = self._shape
        _, _, _, k2 = wavevecs(box_vecs, shape)
        k = safe_sqrt(k2)
        v_ext = torch.zeros(shape, dtype=box_vecs.dtype,
                            device=box_vecs.device)
        counter = 0
        for (_, _, count, _), table in zip(self._ions, self._recpot_tables):
            v_s_ft = self._interp_recpot(table, k)
            positions = cart_ion_coords[counter:counter + count]
            v_ext = v_ext + ion_utils.lattice_sum(box_vecs, shape, positions,
                                                  v_s_ft)
            counter += count
        return v_ext

    def _needs_vext(self):
        return any(term_name(f) == "IonElectron" for f in self._terms)

    def _has_ion_ion(self):
        return any(term_name(f) == "IonIon" for f in self._terms)

    def _update_ionic_potential(self):
        if self._needs_vext():
            cart = self._frac_ion_coords @ self._box_vecs
            self._v_ext = self._potential_from_ions(self._box_vecs, cart)
        else:
            self._v_ext = torch.zeros(self._shape, dtype=_F64,
                                      device=self._device)

    def initialize_density(self):
        """Uniform density n = N_e / vol, and refresh the stored energy."""
        self._den = self._uniform_density()
        self._ene = self._compute_energy()

    def _uniform_density(self):
        return torch.full(self._shape, self._N_elec / self.volume("b3"),
                          dtype=_F64, device=self._device)

    # ------------------------------------------------------------------
    # getters
    # ------------------------------------------------------------------

    def ion_count(self):
        return self._N_ions

    def electron_count(self):
        return self._N_elec

    def cartesian_ionic_coordinates(self, units="a"):
        return (self._frac_ion_coords @ self._box_vecs) \
            * self._unit_factor(units)

    def ionic_potential(self, units="Ha"):
        if units == "Ha":
            return self._v_ext
        if units == "eV":
            return self._v_ext * self.eV_per_Ha
        raise ValueError("units must be 'Ha' or 'eV'")

    def density(self):
        """Electron density (float64, on the system's device)."""
        return self._den

    def energy(self, units="Ha"):
        E = float(self._ene)
        if units == "Ha":
            return E
        if units == "eV":
            return E * self.eV_per_Ha
        raise ValueError("units must be 'Ha' or 'eV'")

    def volume(self, units="b3"):
        v = float(volume(self._box_vecs))
        if units == "b3":
            return v
        if units == "a3":
            return v * self.A_per_b**3
        raise ValueError("units must be 'b3' or 'a3'")

    # ------------------------------------------------------------------
    # energy assembly
    # ------------------------------------------------------------------

    def _density_terms_energy(self, box_vecs, den, v_ext):
        """Sum of all density-dependent terms (ion-ion excluded)."""
        E = torch.zeros((), dtype=den.dtype, device=den.device)
        for f in self._terms:
            nm = term_name(f)
            if nm == "IonElectron":
                E = E + f(box_vecs, den, v_ext)
            elif nm != "IonIon":
                E = E + f(box_vecs, den)
        return E

    def _chi_energy(self, chi, box_vecs, v_ext, N_elec):
        """Energy as a function of the unconstrained sqrt-density variable,
        n = N_e chi^2 / (int chi^2).  f32 floors the density at 1e-10 of
        the mean (renormalised), so negative powers stay finite."""
        chi = chi.reshape(self._shape)
        vol = volume(box_vecs)
        N_tilde = wmean(chi * chi) * vol
        den = (N_elec / N_tilde) * chi * chi
        if chi.dtype == torch.float32:
            c = 1e-10 * N_elec / vol
            den = (den + c) * (N_elec / (N_elec + c * vol))
        return self._density_terms_energy(box_vecs, den, v_ext)

    def _chi_value_and_grad(self, chi, box_vecs, v_ext, N_elec):
        """(E, dE/dchi) by autograd of ``_chi_energy``; the graph lives
        only inside this call."""
        with torch.enable_grad():
            x = chi.detach().requires_grad_(True)
            E = self._chi_energy(x, box_vecs, v_ext, N_elec)
            (g,) = torch.autograd.grad(E, x)
        return E.detach(), g

    def _dEdn(self, box_vecs, den, v_ext):
        """delta E / delta n of the density terms (per unit volume)."""
        return get_functional_derivative(
            box_vecs, den,
            lambda b, n: self._density_terms_energy(b, n, v_ext))

    def _chi_value_and_grad_analytic(self, chi, box_vecs, v_ext, N_elec):
        """(E, dE/dchi) via the fused analytic potentials
        (``models/potentials.py``): one forward sweep, no autograd graph.
        Equal to autograd of ``_chi_energy`` at f64."""
        from .models.potentials import value_and_potential
        shape_in = chi.shape
        chi = chi.reshape(self._shape)
        vol = volume(box_vecs)
        N_tilde = wmean(chi * chi) * vol
        den_pre = (N_elec / N_tilde) * chi * chi
        if chi.dtype == torch.float32:
            c = 1e-10 * N_elec / vol
            s = N_elec / (N_elec + c * vol)
            den = (den_pre + c) * s
        else:
            s = 1.0
            den = den_pre
        E, pot = value_and_potential(self._terms, box_vecs, den, v_ext,
                                     N_elec=N_elec)
        quad_w = vol / den.numel()
        # chain through the chi-parameterisation (+ f32 floor scale s):
        # dE/dchi_j = s (N/N~) 2 chi_j w (pot_j - mu),
        # mu = mean(pot * den_pre) vol / N
        mu = wmean(pot * den_pre) * vol / N_elec
        dEdchi = s * (N_elec / N_tilde) * 2.0 * chi * (pot - mu) * quad_w
        return E, dEdchi.reshape(shape_in)

    def _exact_precond_kernel(self, box_vecs, N_elec):
        """The exact uniform-density inverse-Hessian diagonal M(k) on the
        rfftn half-spectrum.

        The Hessian of the density-terms energy at the uniform density is
        translation invariant, hence diagonal in k-space: ONE Hessian-vector
        product against a delta perturbation (``torch.func.jvp`` over
        ``torch.func.grad``) gives the kernel row, and its FFT the diagonal
        F(k).  Runs in the dtype of ``box_vecs``."""
        shape = self._shape
        dt, dev = box_vecs.dtype, box_vecs.device
        vol = volume(box_vecs)
        n_tot = int(np.prod(shape))
        n0_field = (N_elec / vol) * torch.ones(shape, dtype=dt, device=dev)
        delta = torch.cat([torch.ones(1, dtype=dt, device=dev),
                           torch.zeros(n_tot - 1, dtype=dt, device=dev)]
                          ).reshape(shape)
        v_zero = torch.zeros(shape, dtype=dt, device=dev)  # linear term

        grad_E = torch.func.grad(
            lambda den: self._density_terms_energy(box_vecs, den, v_zero))
        _, hvp = torch.func.jvp(grad_E, (n0_field,), (delta,))
        F = rfftn(hvp).real.to(dt).contiguous()
        # positive floor: k=0 carries no Hartree and is projected out by the
        # normalisation anyway; guards isolated non-SPD modes
        floor = 1e-8 * torch.max(F)
        return 1.0 / torch.maximum(F, floor)

    def _precond_kernel(self, box_vecs, N_elec):
        """Exact preconditioner kernel M(k), full-grid HVP.  Grids above
        256^3 need the radially sampled surrogate, which is not ported."""
        if int(np.prod(self._shape)) > 256 ** 3:
            raise NotImplementedError(
                "the radial preconditioner for grids above 256^3 is not "
                "ported yet: ROADMAP A5")
        return self._exact_precond_kernel(box_vecs, N_elec)

    def _apply_spectral(self, M):
        shape = self._shape

        def apply_H0(q):
            # dedicated convolution: the CUDA kernel on the card
            return spectral_convolution(M, q.reshape(shape),
                                        shape).reshape(q.shape)

        return apply_H0

    # -- ion-ion --------------------------------------------------------

    def _Rc_Rd(self):
        """Cutoff/damping heuristic from the concrete cell."""
        bv = self._box_vecs.cpu().numpy()
        inv_T = np.linalg.inv(bv.T)
        h = 1.0 / np.sqrt(np.sum(inv_T**2, axis=1))
        h_max = float(np.max(h))
        if self._Rc is None:
            Rd = 2.0 * h_max
            Rc = 3.0 * Rd * Rd / h_max
        else:
            Rc = self._Rc
            Rd = float(np.sqrt(h_max * Rc / 3.0))
        return Rc, Rd

    def _get_shifts(self, Rc):
        bv = self._box_vecs.cpu().numpy()
        key = (bv.tobytes(), float(Rc))
        if self._shifts_key != key:
            self._shifts = ion_utils.neighbor_shifts(bv, Rc)
            self._shifts_key = key
        return self._shifts

    def _ion_ion_interaction(self, box_vecs, cart_ion_coords):
        """Real-space ion-ion energy; differentiable with respect to the
        box and coordinates."""
        Rc, Rd = self._Rc_Rd()
        shifts = self._get_shifts(Rc)
        E = ion_utils.ion_interaction_sum(box_vecs, cart_ion_coords,
                                          self._charges, Rc, Rd,
                                          shifts=shifts)
        if not E.requires_grad:
            self._Eion_cache = float(E)
        return E

    def _compute_energy(self, for_den_opt=False):
        """Total energy of the stored state: density terms, plus ion-ion
        unless ``for_den_opt``."""
        E = self._density_terms_energy(self._box_vecs, self._den, self._v_ext)
        if self._has_ion_ion() and not for_den_opt:
            cart = self._frac_ion_coords @ self._box_vecs
            E = E + self._ion_ion_interaction(self._box_vecs, cart)
        return E

    # ------------------------------------------------------------------
    # density optimization
    # ------------------------------------------------------------------

    def optimize_density(self, ntol=1e-7, n_conv_cond_count=3,
                         n_method="LBFGS", n_step_size=0.1, n_maxiter=1000,
                         conv_target="dE", n_verbose=False,
                         from_uniform=False, potentials=None, jit_loop=False,
                         precondition=None, block=6, skip_iters=5, mesh=None,
                         analytic=False):
        """Minimise the energy over the density, in the working dtype.

        ``jit_loop=False`` (the default) is the host loop of the JAX
        package: each outer step is 6 L-BFGS iterations
        (``precondition=True`` adds the exact uniform-density
        preconditioner) or one BB1 TPGD step, with the autograd chi
        gradient (``analytic`` is not read there, as in the JAX package);
        the convergence measure (``conv_target``: |dE| in eV, max
        |dE/dchi| or the Euler residual max |mu - dE/dn|) must fall below
        ``ntol`` for ``n_conv_cond_count`` consecutive outer steps after
        the first 5.

        ``jit_loop=True`` is the JAX package's whole-optimization program,
        run here as a host loop that reads one scalar per check: L-BFGS in
        blocks of ``block`` iterations, or preconditioned BB2 TPGD with
        stagnation damping, checked after ``skip_iters`` outer steps;
        ``analytic=True`` takes the fused analytic chi gradient, and
        ``precondition=True`` the exact preconditioner built once.  In
        float32 L-BFGS is not expected to converge (its curvature pairs
        turn into rounding noise near the minimum); TPGD is the f32 path.

        ``potentials=`` and ``mesh=`` are not ported and raise.  Returns
        (outer steps, converged)."""
        if potentials is not None:
            raise NotImplementedError(
                "user-supplied potentials are not ported yet: ROADMAP A6")
        if mesh is not None:
            raise NotImplementedError(
                "multi-device runs are not ported yet: ROADMAP A11")
        if n_method not in ("LBFGS", "TPGD"):
            raise ValueError("n_method must be 'LBFGS' or 'TPGD'")
        if conv_target not in ("dE", "dEdchi", "euler"):
            raise ValueError("conv_target must be 'dE', 'dEdchi' or 'euler'")
        if jit_loop and analytic:
            from .models.potentials import supported_terms
            if not supported_terms(self._terms):
                raise NotImplementedError(
                    "analytic=True needs a fused analytic potential for "
                    "every term; the other functionals are not ported yet: "
                    "ROADMAP A7")

        if from_uniform:
            self._den = self._uniform_density()
        else:
            current_den = self._den
            current_E = float(self._compute_energy(for_den_opt=True))
            self._den = self._uniform_density()
            uniform_E = float(self._compute_energy(for_den_opt=True))
            if current_E < uniform_E:
                self._den = current_den

        dt = self._dtype
        box = self._box_vecs.to(dt)
        v_ext = self._v_ext.to(dt)
        N_elec = float(self._N_elec)
        chi0 = safe_sqrt(self._den).to(dt)
        vg_auto = lambda x: self._chi_value_and_grad(x, box, v_ext, N_elec)
        # the host loop's TPGD step takes no preconditioner
        aH0 = (self._apply_spectral(self._precond_kernel(box, N_elec))
               if precondition and (jit_loop or n_method == "LBFGS")
               else None)

        if jit_loop:
            vg = vg_auto if not analytic else (
                lambda x: self._chi_value_and_grad_analytic(x, box, v_ext,
                                                            N_elec))
            minimize = (solvers.tpgd_minimize if n_method == "TPGD"
                        else functools.partial(solvers.lbfgs_minimize,
                                               block=block))
            state, n_it, conv = minimize(
                vg, chi0, lr=n_step_size, ntol=ntol,
                conv_count=n_conv_cond_count, max_iter=round(n_maxiter),
                f_scale=EV_PER_HA, skip_iters=skip_iters, apply_H0=aH0,
                stop_fn=self._make_stop_fn(conv_target, box, v_ext, N_elec))
        else:
            state, n_it, conv = self._host_loop(
                vg_auto, chi0, n_method, n_step_size, aH0, ntol,
                n_conv_cond_count, round(n_maxiter), conv_target, n_verbose)
        self._set_den_from_chi(state.x)
        E = state.f.to(_F64)
        if self._has_ion_ion():
            # set by the last _compute_energy of the current cell and ions
            E = E + self._Eion_cache
        self._ene = E
        if n_verbose:
            word = "successfully converged" if conv else "failed to converge"
            print(f"Density optimization {word} in {n_it} step(s)\n")
        return n_it, conv

    def _host_loop(self, vg, chi0, n_method, lr, aH0, ntol, conv_count,
                   max_iter, conv_target, verbose):
        """The JAX package's host loop (``system.py:1126-1211``): one
        outer step per iteration, the stopping rule on the host with the
        same E_prev bookkeeping, checked from the 6th outer step on."""
        if n_method == "LBFGS":
            step = lambda st: solvers.lbfgs_iterations(vg, st, 6, lr,
                                                       apply_H0=aH0)
            state = solvers.lbfgs_init(vg, chi0)
        else:
            step = lambda st: solvers.tpgd_step(vg, lr, st)
            state = solvers.tpgd_init(vg, chi0)
        quad_w = self.volume("b3") / chi0.numel()
        E_prev = float(state.f) * EV_PER_HA
        if verbose:
            print("Starting density optimization")
            print("{:^8} {:^12} {:^12} {:^18} {:^18}".format(
                "Iter", "E [eV]", "dE [eV]", "Max |dE/dchi|",
                "Max |mu-dE/dn|"))
        conv_counter = it = 0
        for it in range(1, max_iter + 1):
            state = step(state)
            E = float(state.f) * EV_PER_HA
            dE = E - E_prev
            E_prev = E
            dEdchi = euler = None
            if verbose or conv_target == "dEdchi":
                dEdchi = float(torch.max(torch.abs(state.g))) / quad_w
            if verbose or conv_target == "euler":
                self._set_den_from_chi(state.x)
                euler = self.check_density_convergence("euler")
            if verbose:
                print("{:^8} {:^12.6f} {:^12.6g} {:^18.6g} {:^18.6g}".format(
                    it, E, dE, dEdchi, euler))
            stop_var = {"dE": abs(dE), "dEdchi": dEdchi,
                        "euler": euler}[conv_target]
            if it > 5:
                conv_counter = conv_counter + 1 if stop_var < ntol else 0
            if conv_counter == conv_count:
                break
        return state, it, conv_counter == conv_count

    def _make_stop_fn(self, conv_target, box_vecs, v_ext, N_elec):
        """Convergence measure of the ``jit_loop`` solvers, one evaluation
        per outer step; ``None`` for 'dE' (the solvers' own |dE|)."""
        if conv_target == "dE":
            return None
        if conv_target == "dEdchi":
            def stop_fn(st, f_prev):
                quad_w = volume(box_vecs) / st.x.numel()
                return torch.max(torch.abs(st.g)) / quad_w
            return stop_fn

        def stop_fn(st, f_prev):
            chi = st.x.reshape(self._shape)
            vol = volume(box_vecs)
            den = (N_elec / (wmean(chi * chi) * vol)) * chi * chi
            dEdn = self._dEdn(box_vecs, den, v_ext)
            mu = wmean(dEdn * den) * vol / N_elec
            return torch.max(torch.abs(mu - dEdn))
        return stop_fn

    def _set_den_from_chi(self, chi):
        chi = chi.reshape(self._shape)
        N_tilde = wmean(chi * chi) * self.volume("b3")
        self._den = ((self._N_elec / N_tilde) * chi * chi).to(_F64)

    # ------------------------------------------------------------------
    # convergence diagnostics
    # ------------------------------------------------------------------

    def functional_derivative(self, type="density"):
        """delta E / delta n or delta E / delta chi at the stored density,
        in atomic units (per unit volume: divided by the quadrature
        weight)."""
        if type == "density":
            return self._dEdn(self._box_vecs, self._den, self._v_ext)
        if type == "chi":
            _, g = self._chi_value_and_grad(safe_sqrt(self._den),
                                            self._box_vecs, self._v_ext,
                                            self._N_elec)
            return g / (self.volume("b3") / self._den.numel())
        raise ValueError("type must be 'density' or 'chi'")

    def check_density_convergence(self, method="dEdchi"):
        """Max |dE/dchi| or the Euler residual max |mu - dE/dn|."""
        if method == "dEdchi":
            return float(torch.max(torch.abs(
                self.functional_derivative("chi"))))
        if method == "euler":
            dEdn = self.functional_derivative("density")
            mu = wmean(dEdn * self._den) * self.volume("b3") / self._N_elec
            return float(torch.max(torch.abs(mu - dEdn)))
        raise ValueError("method must be 'dEdchi' or 'euler'")

    def chemical_potential(self):
        dEdn = self.functional_derivative("density")
        return float(wmean(dEdn * self._den) * self.volume("b3")
                     / self._N_elec)

    # ------------------------------------------------------------------
    # first derivatives: forces and stress
    # ------------------------------------------------------------------

    def forces(self, units="Ha/b"):
        """F = -dE/dR by one reverse pass at the fixed density
        (Hellmann-Feynman: only the ion-electron and ion-ion terms
        depend on the ions)."""
        F = self._compute_forces()
        if units == "Ha/b":
            return F
        if units == "eV/a":
            return F * self.eV_per_Ha / self.A_per_b
        raise ValueError("units must be 'Ha/b' or 'eV/a'")

    def _compute_forces(self):
        box = self._box_vecs
        cart = (self._frac_ion_coords @ box).detach().requires_grad_(True)
        U = torch.zeros((), dtype=_F64, device=self._device)
        with torch.enable_grad():
            if self._needs_vext():
                U = U + IonElectron(box, self._den,
                                    self._potential_from_ions(box, cart))
            if self._has_ion_ion():
                U = U + self._ion_ion_interaction(box, cart)
            if not U.requires_grad:
                return torch.zeros_like(cart)
            (g,) = torch.autograd.grad(U, cart)
        return -g

    def stress(self, units="Ha/b3"):
        """sigma = sym((dE/dh)^T h) / vol, with the density rescaled by
        vol0 / vol(h) so the electron number stays fixed.  The energy goes
        through the ``torch.fft`` term bodies, never the spectral-
        convolution kernel (which has no gradient with respect to its
        kernel, and so none with respect to the cell)."""
        return self._compute_stress() * self._pressure_unit(units)

    @staticmethod
    def _pressure_unit(units):
        if units == "Ha/b3":
            return 1.0
        if units == "eV/a3":
            return System.eV_per_Ha / System.A_per_b**3
        if units == "GPa":
            return System.GPa_per_atomic
        raise ValueError("units must be 'Ha/b3', 'eV/a3' or 'GPa'")

    def _compute_stress(self):
        box0 = self._box_vecs
        vol0 = self.volume("b3")
        frac = self._frac_ion_coords
        h = box0.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            den = self._den * vol0 / volume(h)
            v_ext = (self._potential_from_ions(h, frac @ h)
                     if self._needs_vext() else self._v_ext)
            E = self._density_terms_energy(h, den, v_ext)
            if self._has_ion_ion():
                E = E + self._ion_ion_interaction(h, frac @ h)
            (dEdh,) = torch.autograd.grad(E, h)
        stress = dEdh.T @ box0 / vol0
        return 0.5 * (stress + stress.T)

    # ------------------------------------------------------------------
    # checkpoint / resume
    # ------------------------------------------------------------------

    def state_dict(self):
        """Snapshot of the mutable state (box, ions, density, potential)
        as tensors, with the keys of the JAX package's ``state_dict``."""
        return {
            "box_vecs": self._box_vecs,
            "frac_ion_coords": self._frac_ion_coords,
            "den": self._den,
            "v_ext": self._v_ext,
            "N_elec": self._N_elec,
            "shape": self._shape,
            "ions": self._ions,
        }

    def load_state_dict(self, state):
        """Restore a snapshot: this package's ``state_dict`` or
        ``convert.system_state_from_jax`` of the JAX package's."""
        if tuple(state["shape"]) != self._shape:
            raise ValueError(
                f"Checkpoint grid shape {tuple(state['shape'])} must match "
                f"the system's {self._shape}.")
        ckpt_ions = [(n, c, z) for (n, _, c, z) in state.get("ions", [])]
        self_ions = [(n, c, z) for (n, _, c, z) in self._ions]
        if ckpt_ions != self_ions:
            raise ValueError(
                f"Checkpoint ions {ckpt_ions} do not match the system's "
                f"{self_ions} (species name/count/charge).")
        self._box_vecs = self._t(state["box_vecs"])
        self._frac_ion_coords = self._t(state["frac_ion_coords"])
        self._den = self._t(state["den"])
        self._v_ext = self._t(state["v_ext"])
        self._N_elec = state["N_elec"]
        self._shifts_key = None
        self._Eion_cache = None
        self._ene = self._compute_energy()
