"""The System class: orbital-free DFT with periodic boundaries (PyTorch).

Port of the ``professad_tpu.system.System`` subset on the density-
optimization path: setup (cell, ions, recpot interpolation, v_ext), the
energy assembly, the fused analytic chi gradient, the exact
uniform-density preconditioner and preconditioned TPGD.

Precision: the state (cell, ion coordinates, density, v_ext) is held in
float64 on ``device``; ``dtype`` is the working dtype of the density
optimization (float32 is the fast tier, float64 the correctness tier).
After an optimization the stored energy is the solver's own energy at the
returned iterate (evaluated in ``dtype`` with f64 accumulation) plus the
ion-ion energy, and the density is stored back in float64.
"""

import numpy as np
import torch

from .ops.grid import (wavevecs, volume, safe_sqrt, inv3x3, rfftn, wmean,
                       spectral_convolution)
from .ops.interp import interpolate
from .ops import solvers
from .models import ions as ion_utils
from .utils.constants import A_PER_B, EV_PER_HA, GPA_PER_ATOMIC
from .utils.naming import term_name

__all__ = ["System"]

_F64 = torch.float64


class System:
    """A periodic system for orbital-free DFT calculations.

    ``device`` / ``dtype``: where the state lives, and the working dtype of
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
        self._device = torch.device("cpu") if device is None \
            else torch.device(device)
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
        """Minimise the energy over the density.

        Ported path: ``n_method="TPGD"``, ``analytic=True``,
        ``precondition=True``, ``conv_target="dE"`` — the fused analytic
        gradient, the exact uniform-density preconditioner built once per
        run, and preconditioned TPGD (``ops/solvers.py``) in the working
        dtype, stopping when |dE| < ``ntol`` eV for ``n_conv_cond_count``
        iterations in a row after ``skip_iters``.  ``jit_loop`` is accepted
        for signature parity: the loop is always a host loop reading one
        scalar per iteration.  Other settings raise NotImplementedError.
        ``block`` only applies to L-BFGS and is ignored, as in the JAX
        package's TPGD path.  Returns (iterations, converged)."""
        if n_method != "TPGD":
            raise NotImplementedError(
                f"n_method={n_method!r} is not ported yet (L-BFGS and the "
                "host-loop optimizers): ROADMAP A6")
        if not analytic:
            raise NotImplementedError(
                "analytic=False (autograd chi gradient) is not ported yet: "
                "ROADMAP A6")
        if precondition is not True:
            raise NotImplementedError(
                "only precondition=True is ported: ROADMAP A6")
        if conv_target != "dE":
            raise NotImplementedError(
                f"conv_target={conv_target!r} is not ported yet: ROADMAP A6")
        if potentials is not None:
            raise NotImplementedError(
                "user-supplied potentials are not ported yet: ROADMAP A6")
        if mesh is not None:
            raise NotImplementedError(
                "multi-device runs are not ported yet: ROADMAP A11")
        from .models.potentials import supported_terms
        if not supported_terms(self._terms):
            raise NotImplementedError(
                "analytic=True needs a fused analytic potential for every "
                "term; the other functionals are not ported yet: ROADMAP A7")

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

        Mk = self._precond_kernel(box, N_elec)
        vg = lambda x: self._chi_value_and_grad_analytic(x, box, v_ext,
                                                         N_elec)
        state, n_it, conv = solvers.tpgd_minimize(
            vg, chi0, lr=n_step_size, ntol=ntol,
            conv_count=n_conv_cond_count, max_iter=round(n_maxiter),
            f_scale=EV_PER_HA, skip_iters=skip_iters,
            apply_H0=self._apply_spectral(Mk))
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

    def _set_den_from_chi(self, chi):
        chi = chi.reshape(self._shape)
        N_tilde = wmean(chi * chi) * self.volume("b3")
        self._den = ((self._N_elec / N_tilde) * chi * chi).to(_F64)

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
