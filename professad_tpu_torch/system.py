"""The System class: orbital-free DFT with periodic boundaries (PyTorch).

Port of the single-device ``professad_tpu.system.System``: setup (cell,
ions, recpot interpolation, v_ext from the exact or the particle-mesh
Ewald structure factor), the setters and getters, the energy assembly,
the chi gradient (fused analytic, autograd of the energy, or a
user-supplied potential), the exact uniform-density preconditioner (the
full-grid Hessian-vector product, or above 256^3 its radially sampled
surrogate), the L-BFGS and TPGD density optimizers with the ``dE`` /
``dEdchi`` / ``euler`` stopping rules, the convergence diagnostics, the
Hellmann-Feynman forces, pressure and enthalpy, the stress by autograd,
the second derivatives through the ground state (bulk modulus, elastic
constants, force constants) and the ground-state properties
differentiable with respect to a trainable functional's parameters
(``gs_property_fn``, ``gs_volume_property_fn``), the geometry relaxations
(``optimize_geometry``, ``optimize_parameterized_geometry``) with their
host optimizers, checkpoints, ``set_device``, the EOS scan (``eos_fit``):
serial, or all volumes at once as lanes of one vmapped solve
(``batched=True``), and the multi-device (mesh) paths.

Multi-device runs (``set_mesh``, ``optimize_density(mesh=)``) are SPMD on
``torch.distributed``: one process per device, every rank building the
same System and calling the same methods (``parallel/mesh.py``).  Each rank
keeps the whole float64 state; set-up (recpot tables, structure factor,
v_ext, the preconditioner kernel M(k)) is computed whole and sliced, as the
JAX package computes it globally and places it with a sharding.  The
distributed work runs on each rank's axis-0 slab of every field and axis-1
k-pencil of every spectrum (``parallel/pfft.py``, ``ops.grid.pencil_mode``):
the density solve, the energy, forces and stress, the Hessian solves of
the second derivatives and the geometry gradients.  ``optimize_density``
all-gathers the converged slab once, at its end, so the getters of whole
fields (``density()`` and the like) are local reads of a state that every
rank holds alike.  Energies, forces and stress are all-reduced, so every
rank returns the same values.

Precision: the state (cell, ion coordinates, density, v_ext) is held in
float64 on ``device`` (``None`` means ``cuda:0``; pass ``device="cpu"`` for
the CPU); ``dtype`` is the working dtype of the density optimization
(float32 is the fast tier, float64 the correctness tier; the L-BFGS paths
are held to the JAX package in float64 only).  After an optimization the
density is stored back in float64, and the stored energy is the solver's
own energy at the returned iterate (evaluated in ``dtype`` with f64
accumulation) plus the ion-ion energy; with a term that has ``prepare``
(the ladder terms HC, revHC and YukawaGGA, and MGP) the density-terms part
is instead a direct f64 evaluation at the stored density, which sizes the
ladder from that density, as the JAX package's stored energy does.  The
getters of derivatives work in float64 from the stored state.
"""

import functools
import itertools
import pickle
import sys
import types
import warnings

import numpy as np
import torch
from torch import nn

from .ops.grid import (wavevecs, volume, safe_sqrt, inv3x3, rfftn, wmean,
                       spectral_convolution, spectral_resample, pencil_mode,
                       _chi_map, _chi_chain)
from .ops.interp import interpolate
from .ops import solvers
from .ops import implicit
from .ops.autodiff import get_functional_derivative
from .models import ions as ion_utils
from .models.interaction import IonElectron
from .utils.constants import A_PER_B, EV_PER_HA, GPA_PER_ATOMIC
from .utils.elastic import fit_eos
from .utils.naming import term_name
from .utils.device import resolve_device

__all__ = ["System"]

_F64 = torch.float64
_MODELS = __package__ + ".models."

precond_kernel_builds = 0   # preconditioner kernels M(k) built for a cell
precond_kernel_hits = 0     # M(k) taken from the System's cache entry


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
        if dtype not in (torch.float32, torch.float64):
            raise ValueError("dtype must be torch.float32 or torch.float64")
        self._terms = list(terms)
        self._shape = tuple(int(s) for s in shape)
        self._pme_order = pme_order
        self._Rc = Rc
        self._device = resolve_device(device)
        self._dtype = dtype
        self._Eion_cache = None
        self._shifts = None
        self._shifts_key = None
        self._precond_entry = None
        self._mesh = None

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
        N_elec, ion_list, coords, name = 0, [], [], ""
        self._recpot_tables = []
        for species in ions:
            ks, pot_ft, charge = ion_utils.read_recpot(species[1])
            self._recpot_tables.append((self._t(ks), self._t(pot_ft), charge))
            c = torch.as_tensor(species[2], dtype=_F64).cpu().numpy()
            count = int(c.shape[0])
            ion_list.append((species[0], species[1], count, charge))
            coords.append(c)
            N_elec += count * charge
            name += species[0] + str(count)
        self._name = name
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
        self._frac_ion_coords = _wrap(frac)
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

    def _potential_from_ions(self, box_vecs, cart_ion_coords, shape=None):
        """v_ext(r) from the recpot tables; differentiable with respect to
        (box_vecs, cart_ion_coords).  ``shape``: the grid to build on (the
        System's by default; under ``ops.grid.pencil_mode`` the local slab
        shape, and the result is this rank's slab)."""
        shape = self._shape if shape is None else tuple(shape)
        _, _, _, k2 = wavevecs(box_vecs, shape)
        k = safe_sqrt(k2)
        v_ext = torch.zeros(shape, dtype=box_vecs.dtype,
                            device=box_vecs.device)
        counter = 0
        for (_, _, count, _), table in zip(self._ions, self._recpot_tables):
            v_s_ft = self._interp_recpot(table, k)
            positions = cart_ion_coords[counter:counter + count]
            v_ext = v_ext + ion_utils.lattice_sum(box_vecs, shape, positions,
                                                  v_s_ft, self._pme_order)
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

    def set_potential(self, pot):
        """Set an explicit external potential (Ha, on the system's grid)."""
        if tuple(pot.shape) != self._shape:
            raise ValueError(
                f"Shape of new potential {tuple(pot.shape)} must match the "
                f"system's {self._shape}.")
        self._v_ext = self._t(pot)
        self._ene = self._compute_energy()

    def set_density(self, den, resample=False):
        """Set the electron density.  ``resample=True`` also takes a
        density on another grid over the same cell: it is resampled in
        chi = sqrt(n) (``grid.spectral_resample``, so the result stays
        nonnegative) and renormalised to the electron count, the warm
        start of a finer grid from a converged coarse one."""
        den = self._t(den)
        if tuple(den.shape) != self._shape:
            if not resample:
                raise ValueError(
                    f"Shape of new density {tuple(den.shape)} must match "
                    f"the system's {self._shape} (or pass resample=True).")
            chi = spectral_resample(safe_sqrt(den), self._shape)
            den = chi * chi
            den = den * (self._N_elec / (wmean(den) * self.volume("b3")))
        self._den = den
        self._ene = self._compute_energy()

    def set_electron_number(self, N):
        self._N_elec = N

    def detach(self):
        """Drop any autograd graph from the stored state."""
        self._box_vecs = self._box_vecs.detach()
        self._frac_ion_coords = self._frac_ion_coords.detach()
        self._den = self._den.detach()
        self._v_ext = self._v_ext.detach()
        if torch.is_tensor(self._ene):
            self._ene = self._ene.detach()

    def set_Rc(self, Rc=None):
        """Set the ion-ion real-space cutoff (``None``: the heuristic)."""
        self._Rc = Rc
        self._shifts_key = None

    def set_device(self, device=None):
        """Move every tensor the System holds to ``device`` (``None``
        means ``cuda:0``): the cell, ion coordinates and charges, density,
        external potential, stored energy, the recpot tables, and each
        term's parameters and prepared ladder, kernel tables and slabs.
        The cached preconditioner kernel is dropped (the next run builds
        it on ``device``).  Later runs allocate on ``device`` only."""
        dev = resolve_device(device)
        self._device = dev
        self._precond_entry = None
        self._box_vecs = self._box_vecs.to(dev)
        self._frac_ion_coords = self._frac_ion_coords.to(dev)
        self._charges = self._charges.to(dev)
        self._den = self._den.to(dev)
        self._v_ext = self._v_ext.to(dev)
        if torch.is_tensor(self._ene):
            self._ene = self._ene.to(dev)
        self._recpot_tables = [(ks.to(dev), pot.to(dev), z)
                               for ks, pot, z in self._recpot_tables]
        owners = {id(o): o for o in (getattr(f, "__self__", f)
                                     for f in self._terms)}
        for owner in owners.values():
            if callable(getattr(owner, "set_device", None)):
                owner.set_device(dev)

    def set_mesh(self, mesh):
        """Attach (or detach, with None) a ``DeviceMesh`` with a "grid" axis
        (``parallel.make_mesh``).  With a mesh attached the energy,
        ``forces()``, ``stress()``, the pressure, enthalpy and second
        derivatives, and the geometry relaxations' gradients and density
        re-optimizations run distributed over its "grid" axis (every rank
        must then call them).  ``optimize_density(mesh=...)`` attaches its
        mesh."""
        if mesh is not None:
            _check_mesh(mesh)
        if mesh is not None and self._shape[0] % mesh["grid"].size():
            raise ValueError(
                f"grid axis 0 ({self._shape[0]}) must divide by the mesh "
                f"'grid' size {mesh['grid'].size()}")
        self._mesh = mesh

    # -- the mesh's slabs ------------------------------------------------
    # ``group``: the "grid" process group of the mesh (``_grid_group``), or
    # None serially, where the slab is the whole field.

    def _pencil_local_shape(self, group):
        if group is None:
            return self._shape
        from .parallel.collectives import axis_size
        n_dev = axis_size(group)
        if self._shape[0] % n_dev or self._shape[1] % n_dev:
            raise ValueError(
                f"pencil decomposition needs grid axes 0 and 1 divisible "
                f"by the mesh 'grid' size {n_dev}; got {self._shape}")
        return (self._shape[0] // n_dev, self._shape[1], self._shape[2])

    def _slab(self, x, group):
        """This rank's axis-0 slab of a whole field."""
        if group is None:
            return x
        from .parallel.collectives import axis_index
        n0 = self._pencil_local_shape(group)[0]
        return x.narrow(0, axis_index(group) * n0, n0)

    # ------------------------------------------------------------------
    # getters
    # ------------------------------------------------------------------

    def device(self):
        return self._device

    def name(self):
        return self._name

    def ion_count(self):
        return self._N_ions

    def electron_count(self):
        return self._N_elec

    def lattice_vectors(self, units="a"):
        return self._unit_factor(units) * self._box_vecs

    def ions(self):
        return self._ions

    def cartesian_ionic_coordinates(self, units="a"):
        return (self._frac_ion_coords @ self._box_vecs) \
            * self._unit_factor(units)

    def fractional_ionic_coordinates(self):
        return self._frac_ion_coords

    def ionic_potential(self, units="Ha"):
        if units == "Ha":
            return self._v_ext
        if units == "eV":
            return self._v_ext * self.eV_per_Ha
        raise ValueError("units must be 'Ha' or 'eV'")

    @staticmethod
    def _warn_requires_grad(method):
        """The reference returned graph-connected tensors from
        ``density`` / ``energy`` / ``pressure`` / ``bulk_modulus``
        (``requires_grad=True``); here, as in the JAX package, the value
        is detached, and gradients of ground-state properties go through
        ``gs_property_fn`` / ``gs_volume_property_fn``.  Warn rather than
        detach silently."""
        warnings.warn(
            f"System.{method}(requires_grad=True): the returned value is "
            "NOT graph-connected. For gradients of ground-state properties "
            "with respect to functional parameters use "
            "System.gs_property_fn / gs_volume_property_fn (implicit "
            "differentiation through the minimizer).",
            UserWarning, stacklevel=3)

    def density(self, requires_grad=False):
        """Electron density (float64, on the system's device), the whole
        grid on every rank of a meshed System (gathered where a mesh
        solve ends, so reading it is not a collective);
        ``requires_grad=True`` warns (see ``gs_property_fn``)."""
        if requires_grad:
            self._warn_requires_grad("density")
            return self._den.detach()
        return self._den

    def energy(self, units="Ha", requires_grad=False):
        if requires_grad:
            self._warn_requires_grad("energy")
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

    def _density_terms_energy(self, box_vecs, den, v_ext, aux=None,
                              static=True, functional=None, params=None):
        """Sum of all density-dependent terms (ion-ion excluded).

        The ladder terms (HC, revHC, YukawaGGA) take the ladder their
        ``prepare`` cached (``forward_static``) unless ``static=False``
        (the stored energy: a direct evaluation, which sizes the ladder
        from the density), as the JAX package does in its traced and its
        eager calls.  ``aux``: the per-term list of ``_collect_term_aux``
        (hoisted kernel slabs), for the density optimizer paths only; the
        slabs depend on the cell, so the paths that differentiate with
        respect to it (stress, geometry) must not pass them.  The term
        ``functional`` (a trainable one) is evaluated with ``params``
        (``functional.apply(params, box_vecs, den)``), so that they carry
        the gradient."""
        E = torch.zeros((), dtype=den.dtype, device=den.device)
        for i, f in enumerate(self._terms):
            nm = term_name(f)
            owner = getattr(f, "__self__", f)
            a = aux[i] if aux is not None else None
            if functional is not None and f is functional:
                E = E + functional.apply(params, box_vecs, den)
            elif a is not None:
                E = E + owner.apply_aux(a, box_vecs, den)
            elif nm == "IonElectron":
                E = E + f(box_vecs, den, v_ext)
            elif nm == "IonIon":
                continue
            elif static and hasattr(owner, "forward_static"):
                E = E + owner.forward_static(box_vecs, den)
            else:
                E = E + f(box_vecs, den)
        return E

    def _collect_term_aux(self):
        """The per-cell arrays of the terms with ``aux_arrays()`` (filled
        by their ``prepare``), one entry per term; None if no term has
        any."""
        aux = [getattr(getattr(f, "__self__", f), "aux_arrays",
                       lambda: None)() for f in self._terms]
        return aux if any(a is not None for a in aux) else None

    def _prepare_terms(self):
        """Terms with per-cell prepared state (``prepare()``)."""
        return [getattr(f, "__self__", f) for f in self._terms
                if callable(getattr(getattr(f, "__self__", f), "prepare",
                                    None))]

    def _prepare_dynamic_kernels(self):
        """Let the terms with data-dependent kernels (HC, revHC, Yukawa,
        MGP) cache their ladders and tables from the stored density."""
        for owner in self._prepare_terms():
            owner.prepare(self._box_vecs, self._den)

    def _chi_energy(self, chi, box_vecs, v_ext, N_elec, aux=None):
        """Energy as a function of the unconstrained sqrt-density variable,
        n = N_e chi^2 / (int chi^2), with the float32 floor of
        ``grid._chi_map``."""
        den = _chi_map(chi.reshape(self._shape), volume(box_vecs), N_elec)[1]
        return self._density_terms_energy(box_vecs, den, v_ext, aux=aux)

    def _chi_value_and_grad(self, chi, box_vecs, v_ext, N_elec, aux=None):
        """(E, dE/dchi) by autograd of ``_chi_energy``; the graph lives
        only inside this call."""
        with torch.enable_grad():
            x = chi.detach().requires_grad_(True)
            E = self._chi_energy(x, box_vecs, v_ext, N_elec, aux)
            (g,) = torch.autograd.grad(E, x)
        return E.detach(), g

    @torch.no_grad()
    def _chi_value_and_grad_potentials(self, chi, box_vecs, v_ext, N_elec,
                                       potentials):
        """(E, dE/dchi) with dE/dn from a user-supplied
        ``potentials(box_vecs, den)``, chained through the chi
        parameterisation as in the JAX package."""
        x = chi.reshape(self._shape)
        vol = volume(box_vecs)
        den, _, _, N_tilde = _chi_map(x, vol, N_elec)
        E = self._density_terms_energy(box_vecs, den, v_ext)
        dEdn = potentials(box_vecs, den)
        return E, _chi_chain(x, dEdn, den, 1.0, N_tilde, vol,
                             N_elec).reshape(chi.shape)

    def _dEdn(self, box_vecs, den, v_ext, aux=None):
        """delta E / delta n of the density terms (per unit volume)."""
        return get_functional_derivative(
            box_vecs, den,
            lambda b, n: self._density_terms_energy(b, n, v_ext, aux=aux))

    def _chi_value_and_grad_analytic(self, chi, box_vecs, v_ext, N_elec,
                                     aux=None, sweep=None):
        """(E, dE/dchi) via the fused analytic potentials
        (``models/potentials.py``): one forward sweep, no autograd graph.
        Equal to autograd of ``_chi_energy`` at f64.  ``sweep``: the terms'
        sweep bound once for a whole solve (``potentials.bind_sweep``), or
        None to bind it in this call."""
        if sweep is None:
            from .models.potentials import bind_sweep
            sweep = bind_sweep(self._terms, aux)
        x = chi.reshape(self._shape)
        vol = volume(box_vecs)
        den_pre, den, s, N_tilde = _chi_map(x, vol, N_elec)
        E, pot = sweep(box_vecs, den, v_ext, N_elec=N_elec)
        return E, _chi_chain(x, pot, den_pre, s, N_tilde, vol,
                             N_elec).reshape(chi.shape)

    def _exact_precond_kernel(self, box_vecs, N_elec, aux=None):
        """The exact uniform-density inverse-Hessian diagonal M(k) on the
        rfftn half-spectrum.

        The Hessian of the density-terms energy at the uniform density is
        translation invariant, hence diagonal in k-space: ONE Hessian-vector
        product against a delta perturbation (``torch.func.jvp`` over
        ``torch.func.grad``) gives the kernel row, and its FFT the diagonal
        F(k).  Runs in the dtype of ``box_vecs``; ``aux`` as in
        ``_density_terms_energy``."""
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
            lambda den: self._density_terms_energy(box_vecs, den, v_zero,
                                                   aux=aux))
        _, hvp = torch.func.jvp(grad_E, (n0_field,), (delta,))
        F = rfftn(hvp).real.to(dt).contiguous()
        # positive floor: k=0 carries no Hartree and is projected out by the
        # normalisation anyway; guards isolated non-SPD modes
        floor = 1e-8 * torch.max(F)
        # a constant of the solver: no graph to a trainable term's params
        return (1.0 / torch.maximum(F, floor)).detach()

    def _exact_precond_kernel_radial(self, box_vecs, N_elec, n1d=4096):
        """Radially sampled exact preconditioner kernel, for grids above
        256^3, where the full-grid HVP's temporaries grow large.

        F(k) at the uniform density is radial for every term without
        ``prepare``, so the same HVP runs on a degenerate (n1d, 1, 1) ray
        cell whose k_x axis covers 1.02 |k|max of the target grid, at the
        same n0.  M = 1/F is Hermite-interpolated (uniform knots) onto
        |k|: M ~ k^2 is smooth where F ~ 1/k^2 (Hartree) is not.  F is
        then averaged over conjugate pairs on the k3 = 0 and Nyquist planes,
        as the full-grid HVP does.  The grid's quadrature factor differs
        between the ray and the target grid; the solvers' BB / L-BFGS
        scaling cancels that constant."""
        from .ops.interp import _tangents, _hermite_weights
        shape = self._shape
        dt, dev = box_vecs.dtype, box_vecs.device
        _, _, _, k2 = wavevecs(box_vecs, shape)
        kq = safe_sqrt(k2)
        kmax = torch.sqrt(torch.max(k2))
        Lx = np.pi * n1d / (1.02 * kmax)    # ray k_max = 1.02 |k|max
        a = Lx / n1d                         # transverse cell (arbitrary)
        box_s = torch.diag(torch.stack([Lx, a, a])).to(dt)
        n0 = N_elec / volume(box_vecs)
        shape_s = (n1d, 1, 1)
        n0_field = n0 * torch.ones(shape_s, dtype=dt, device=dev)
        delta = torch.zeros(shape_s, dtype=dt, device=dev)
        delta[0, 0, 0] = 1.0
        v_zero = torch.zeros(shape_s, dtype=dt, device=dev)
        grad_E = torch.func.grad(
            lambda den: self._density_terms_energy(box_s, den, v_zero))
        _, hvp = torch.func.jvp(grad_E, (n0_field,), (delta,))
        # the ray axis is a full FFT: keep F at k_j = 2 pi j / Lx, j >= 0
        F1 = rfftn(hvp).real.to(dt).reshape(-1)[: n1d // 2 + 1]
        kx = (2.0 * np.pi / Lx) * torch.arange(n1d // 2 + 1, dtype=dt,
                                               device=dev)
        step = kx[1]
        M1 = 1.0 / torch.maximum(F1, 1e-8 * torch.max(F1))
        idx = torch.clamp(torch.floor(kq / step).to(torch.long), 0,
                          kx.numel() - 2)
        m = _tangents(kx, M1)
        t = (kq - idx.to(dt) * step) / step
        h00, h10, h01, h11 = _hermite_weights(t)
        M = (h00 * M1[idx] + h10 * m[idx] * step
             + h01 * M1[idx + 1] + h11 * m[idx + 1] * step)
        F = 1.0 / torch.maximum(M, 1e-12 * torch.max(M1))
        # conjugate pairs (i, j) -> (-i, -j) on the real-field constraint
        # planes: at a Nyquist index their |k| differ in a skewed cell
        planes = [0] + ([shape[2] // 2] if shape[2] % 2 == 0 else [])
        for zp in planes:
            Fp = F[:, :, zp]
            F[:, :, zp] = 0.5 * (Fp + torch.roll(torch.flip(Fp, (0, 1)),
                                                 (1, 1), (0, 1)))
        floor = 1e-8 * torch.max(F)
        return (1.0 / torch.maximum(F, floor)).detach()

    def _radial_n1d(self):
        """The ray of the radially sampled kernel (max(4096, 16 max(shape))
        points) above 256^3, unless a term has ``prepare`` (its slabs
        belong to this grid's ladder), as in the JAX package; None for the
        full-grid HVP."""
        if int(np.prod(self._shape)) > 256 ** 3 and not self._prepare_terms():
            return max(4096, 16 * max(self._shape))
        return None

    def _cell_precond_kernel(self, dtype, full_grid=False, aux=None):
        """M(k) of the System's own cell in ``dtype``: the full-grid HVP,
        or the radially sampled surrogate where ``_radial_n1d`` gives a
        ray; the full-grid HVP whatever the grid with ``full_grid``.

        M depends only on the cell, N_elec, the grid, the dtype and the
        terms, so the last one built is kept (one entry) under
        ``_precond_key`` and returned while the key holds: the very tensor
        a rebuild would return.  Its consumers only read it.  Where there
        is no key, it is built on every call."""
        global precond_kernel_builds, precond_kernel_hits
        n1d = None if full_grid else self._radial_n1d()
        pins = []
        key = self._precond_key(dtype, n1d, pins)
        entry = self._precond_entry
        if key is not None and entry is not None and entry[0] == key:
            precond_kernel_hits += 1
            return entry[2]
        box, N_elec = self._box_vecs.to(dtype), float(self._N_elec)
        if n1d is None:
            M = self._exact_precond_kernel(box, N_elec, aux)
        else:
            M = self._exact_precond_kernel_radial(box, N_elec, n1d=n1d)
        precond_kernel_builds += 1
        self._precond_entry = None if key is None else (key, pins, M)
        return M

    def _precond_key(self, dtype, n1d, pins):
        """What ``_cell_precond_kernel`` builds M from, read on the host:
        the route, dtype, grid, N_elec, and the identity, version and
        storage of the cell and of every parameter and buffer of an
        ``nn.Module`` term (the tensors are appended to ``pins``, which
        the entry keeps, so that no id or address is reused while it
        lives).  None where the state is not visible: a term with
        ``prepare`` (M then depends on the ladder prepared from the
        density), a term that is neither a term function of ``models``
        nor an ``nn.Module``'s, or a cell that requires grad or is a
        transformed tensor (vmap / jvp)."""
        box = self._box_vecs
        if (self._prepare_terms() or box.requires_grad
                or torch._C._functorch.is_functorch_wrapped_tensor(box)):
            return None
        key = [n1d, dtype, self._shape, float(self._N_elec),
               _tensor_token(box, pins)]
        for f in self._terms:
            owner = getattr(f, "__self__", f)
            if isinstance(owner, nn.Module):
                key.append(tuple(
                    _tensor_token(t, pins)
                    for t in itertools.chain(owner.parameters(),
                                             owner.buffers())))
            elif not _is_model_function(f):
                return None
            pins.append(f)
            key.append(id(f))
        return tuple(key)

    def _cg_precond(self, group=None):
        """The CG preconditioner of the second derivatives' Hessian solves:
        q -> M * q with the exact uniform-density kernel of the System's
        cell, f64 and full-grid whatever the grid, as in the JAX package.
        Serially the spectral convolution applies it; with a ``group``,
        q is this rank's slab and the pencil transforms apply this rank's
        k-pencil of M."""
        M = self._cell_precond_kernel(_F64, full_grid=True)
        if group is None:
            return self._apply_spectral(M)
        from .parallel import pfft
        from .parallel.collectives import axis_index, axis_size
        shape = self._shape
        step = shape[1] // axis_size(group)
        M_slab = M.narrow(1, axis_index(group) * step, step)
        return lambda q: pfft.pirfftn(M_slab * pfft.prfftn(q, group), shape,
                                      group)

    def _apply_spectral(self, M):
        shape = self._shape

        def apply_H0(q):
            # dedicated convolution: the CUDA kernel on the card
            return spectral_convolution(M, q.reshape(shape),
                                        shape).reshape(q.shape)

        return apply_H0

    # -- ion-ion --------------------------------------------------------

    def _Rc_Rd(self, box=None):
        """Cutoff/damping heuristic from the concrete cell (the stored one,
        or ``box``)."""
        bv = (self._box_vecs if box is None else box).cpu().numpy()
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

    @torch.no_grad()
    def _compute_energy(self, for_den_opt=False):
        """Total energy of the stored state: density terms, plus ion-ion
        unless ``for_den_opt``.  No graph: a trainable term's parameters
        would otherwise tie one to the stored energy.  With a mesh attached
        the density terms run distributed (collective), with the term-aux
        hoists on the k-pencils where the terms have them, as the JAX
        package's mesh branch does."""
        if self._mesh is not None:
            E = self._mesh_terms_energy(_grid_group(self._mesh))
        else:
            E = self._density_terms_energy(self._box_vecs, self._den,
                                           self._v_ext, static=False)
        if self._has_ion_ion() and not for_den_opt:
            E = E + self._ion_ion_energy()
        return E

    def _mesh_terms_energy(self, group):
        """The density terms of the stored state on the mesh: this rank's
        slabs through ``pfft.penergy_terms``; the replicated sum."""
        from .parallel import pfft
        aux = pfft.aux_pencil_specs(self._collect_term_aux(), group)
        return pfft.penergy_terms(self._terms, self._box_vecs,
                                  self._slab(self._den, group),
                                  self._slab(self._v_ext, group), group,
                                  aux=aux)

    def _ion_ion_energy(self):
        """Ion-ion energy of the stored cell and ions (sets the cache)."""
        cart = self._frac_ion_coords @ self._box_vecs
        return self._ion_ion_interaction(self._box_vecs, cart)

    def _geometry_energy(self, group=None, ion_ion=None, of_density=False):
        """``energy(x, h, cart, params=None, functional=None)``: the energy
        of the cell ``h`` with the ions at ``cart`` at the density of x,
        differentiable with respect to each argument: the one energy to
        which the stress, the second derivatives, the ground-state
        properties and the relaxations map their parameters, serial and on
        a mesh.

        x is chi, whose density is ``grid._chi_map``'s plain map in the
        cell h, or with ``of_density`` the density itself.  With a
        ``group`` x is this rank's slab, the term bodies run under
        ``pencil_mode`` and the value is the replicated global energy.
        v_ext is rebuilt from (h, cart) on the slab where there is an
        IonElectron term; otherwise, or where ``cart`` is None, it is the
        stored one.  The ladder terms take their cached ladder and never
        the hoisted aux slabs, which depend on the cell.  ``functional`` /
        ``params`` as in ``_density_terms_energy``.  ``ion_ion(h, cart)``,
        where the System has an IonIon term, adds the ion-ion energy."""
        local = self._pencil_local_shape(group)
        has_ie = self._needs_vext()
        has_ii = ion_ion is not None and self._has_ion_ion()
        N_elec = self._N_elec

        def energy(x, h, cart, params=None, functional=None):
            with pencil_mode(group):
                v_ext = (self._potential_from_ions(h, cart, local)
                         if has_ie and cart is not None
                         else self._slab(self._v_ext, group))
                den = x if of_density else _chi_map(x, volume(h), N_elec)[0]
                E = self._density_terms_energy(h, den, v_ext,
                                               functional=functional,
                                               params=params)
            if has_ii:
                E = E + ion_ion(h, cart)
            return E

        return energy

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
        ``precondition=True`` the exact preconditioner, built once per
        cell (``_cell_precond_kernel``).  In
        float32 L-BFGS is not expected to converge (its curvature pairs
        turn into rounding noise near the minimum); TPGD is the f32 path.

        ``potentials(box_vecs, den) -> dE/dn`` (host loop only) drives the
        L-BFGS or TPGD step with a user-supplied potential instead of the
        autograd gradient; the energy is still the terms' own, and no
        preconditioner is applied, as in the JAX package.

        ``mesh=`` (a ``DeviceMesh`` with a "grid" axis; every rank calls
        with the same arguments) runs the whole optimization distributed
        over the mesh's "grid" axis (``parallel.pfft.pencil_tpgd_minimize``:
        pencil FFTs, psum'd inner products, the host rule on the same
        all-reduced energy on every rank), TPGD or L-BFGS, with the fused
        analytic gradient (``analytic=True``) or autograd of the serial
        term bodies under ``pencil_mode``; the ladder terms take their
        prepared ladder and hoisted slabs on the k-pencils.  It needs
        ``jit_loop=True`` and ``conv_target="dE"`` and takes no
        ``potentials``; ``precondition=None`` means True there (an explicit
        False is honoured), and the default ``block=6`` means a check every
        L-BFGS iteration.  The mesh stays attached (``set_mesh``), and the
        converged density is gathered to every rank.  Returns (outer
        steps, converged)."""
        if mesh is not None:
            self._check_mesh_run(mesh, jit_loop, potentials, conv_target)
        if n_method not in ("LBFGS", "TPGD"):
            raise ValueError("n_method must be 'LBFGS' or 'TPGD'")
        if conv_target not in ("dE", "dEdchi", "euler"):
            raise ValueError("conv_target must be 'dE', 'dEdchi' or 'euler'")
        if jit_loop and potentials is not None:
            raise ValueError("jit_loop supports autodiff gradients only")
        if jit_loop and analytic:
            from .models.potentials import supported_terms
            if not supported_terms(self._terms):
                raise ValueError(
                    "analytic=True requires every term to have a fused "
                    "analytic potential (models/potentials.py); use the "
                    "autodiff path for this term set.")

        if from_uniform:
            self._den = self._uniform_density()
        else:
            current_den = self._den
            current_E = float(self._compute_energy(for_den_opt=True))
            self._den = self._uniform_density()
            uniform_E = float(self._compute_energy(for_den_opt=True))
            if current_E < uniform_E:
                self._den = current_den

        self._prepare_dynamic_kernels()
        dt = self._dtype
        box = self._box_vecs.to(dt)
        v_ext = self._v_ext.to(dt)
        N_elec = float(self._N_elec)
        chi0 = safe_sqrt(self._den).to(dt)
        aux = self._collect_term_aux()
        if aux is not None:   # cast once to the working dtype
            aux = [None if a is None else {k: v.to(dt) for k, v in a.items()}
                   for a in aux]
        if potentials is None:
            vg_auto = lambda x: self._chi_value_and_grad(x, box, v_ext,
                                                         N_elec, aux)
        else:
            vg_auto = lambda x: self._chi_value_and_grad_potentials(
                x, box, v_ext, N_elec, potentials)
        if mesh is not None:
            from .parallel.pfft import pencil_tpgd_minimize
            from .parallel.mesh import gather_grid
            M = (self._cell_precond_kernel(dt, aux=aux)
                 if precondition is not False else None)
            state, n_it, conv = pencil_tpgd_minimize(
                mesh, self._shape, box, v_ext, N_elec, chi0, M,
                lr=n_step_size, ntol=ntol, conv_count=n_conv_cond_count,
                max_iter=round(n_maxiter), skip_iters=skip_iters,
                f_scale=EV_PER_HA, method=n_method, terms=self._terms,
                aux=aux, analytic=analytic, block=1 if block == 6 else block)
            state = state._replace(x=gather_grid(state.x.reshape(
                self._pencil_local_shape(_grid_group(mesh))), mesh))
            return self._store_optimized(state, n_it, conv, n_verbose)
        # the host loop's TPGD step and the potentials path take no
        # preconditioner
        aH0 = (self._apply_spectral(self._cell_precond_kernel(dt, aux=aux))
               if precondition and potentials is None
               and (jit_loop or n_method == "LBFGS") else None)

        if jit_loop:
            vg, kw = vg_auto, {}
            if analytic:
                vg, kw = self._analytic_solve_fn(box, v_ext, N_elec, aux,
                                                 n_method)
            minimize = (solvers.tpgd_minimize if n_method == "TPGD"
                        else functools.partial(solvers.lbfgs_minimize,
                                               block=block))
            state, n_it, conv = minimize(
                vg, chi0, lr=n_step_size, ntol=ntol,
                conv_count=n_conv_cond_count, max_iter=round(n_maxiter),
                f_scale=EV_PER_HA, skip_iters=skip_iters, apply_H0=aH0,
                stop_fn=self._make_stop_fn(conv_target, box, v_ext, N_elec,
                                           aux), **kw)
        else:
            state, n_it, conv = self._host_loop(
                vg_auto, chi0, n_method, n_step_size, aH0, ntol,
                n_conv_cond_count, round(n_maxiter), conv_target, n_verbose)
        return self._store_optimized(state, n_it, conv, n_verbose)

    def _analytic_solve_fn(self, box, v_ext, N_elec, aux, n_method):
        """The fused analytic chi gradient of one solve, with the terms'
        host scalars read once (``potentials.bind_sweep``), and the
        solver keywords: TPGD may issue its iterations as CUDA graph
        replays where the sweep reads nothing to the host
        (``solvers.tpgd_minimize(capturable=)``)."""
        from .models.potentials import bind_sweep, capturable_terms
        sweep = bind_sweep(self._terms, aux)
        kw = {}
        if n_method == "TPGD":
            kw["capturable"] = capturable_terms(self._terms)
        return (lambda x: self._chi_value_and_grad_analytic(
            x, box, v_ext, N_elec, aux, sweep=sweep)), kw

    def _check_mesh_run(self, mesh, jit_loop, potentials, conv_target):
        """The arguments ``optimize_density(mesh=)`` rejects; attaches the
        mesh."""
        if not jit_loop:
            raise ValueError("mesh= requires jit_loop=True")
        self.set_mesh(mesh)
        if potentials is not None:
            raise ValueError(
                "mesh= supports autodiff or fused analytic gradients only, "
                "not a user-supplied potentials closure")
        if conv_target != "dE":
            raise ValueError(
                "mesh= supports conv_target='dE' only (the dEdchi/euler "
                f"measures have no distributed form; got {conv_target!r})")

    def _store_optimized(self, state, n_it, conv, verbose):
        """Store an optimization's result: the density from chi, and the
        solver's energy (a direct evaluation with a ``prepare`` term) plus
        the ion-ion energy."""
        self._set_den_from_chi(state.x)
        E = state.f.to(_F64)
        if self._prepare_terms():
            # the solver's energy used the ladder prepared from the start
            # density; the stored energy sizes it from this density, as
            # the JAX package's does
            with torch.no_grad():
                E = self._compute_energy(for_den_opt=True).to(_F64)
        if self._has_ion_ion():
            # cached by the last energy of the current cell and ions
            if self._Eion_cache is None:
                with torch.no_grad():
                    self._ion_ion_energy()
            E = E + self._Eion_cache
        self._ene = E
        if verbose:
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

    def _make_stop_fn(self, conv_target, box_vecs, v_ext, N_elec, aux=None):
        """Convergence measure of the ``jit_loop`` solvers, one evaluation
        per outer step; ``None`` for 'dE' (the solvers' own |dE|).  The
        'euler' measure takes the term-aux list."""
        if conv_target == "dE":
            return None
        if conv_target == "dEdchi":
            def stop_fn(st, f_prev):
                quad_w = volume(box_vecs) / st.x.numel()
                return torch.max(torch.abs(st.g)) / quad_w
            return stop_fn

        def stop_fn(st, f_prev):
            vol = volume(box_vecs)
            den = _chi_map(st.x.reshape(self._shape), vol, N_elec)[0]
            dEdn = self._dEdn(box_vecs, den, v_ext, aux)
            mu = wmean(dEdn * den) * vol / N_elec
            return torch.max(torch.abs(mu - dEdn))
        return stop_fn

    def _set_den_from_chi(self, chi):
        self._den = _chi_map(chi.reshape(self._shape), self.volume("b3"),
                             self._N_elec)[0].to(_F64)

    # ------------------------------------------------------------------
    # convergence diagnostics
    # ------------------------------------------------------------------

    def functional_derivative(self, type="density", requires_grad=False):
        """delta E / delta n or delta E / delta chi at the stored density,
        in atomic units (per unit volume: divided by the quadrature
        weight)."""
        if requires_grad:
            self._warn_requires_grad("functional_derivative")
            return self.functional_derivative(type).detach()
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
        """The ion terms' energy alone (no density term depends on the
        ions), differentiated with respect to the coordinates.  On a mesh,
        IonElectron takes this rank's slab, with v_ext rebuilt there (its
        structure factor on the k-pencil)."""
        group = _grid_group(self._mesh)
        box = self._box_vecs
        cart = (self._frac_ion_coords @ box).detach().requires_grad_(True)
        U = torch.zeros((), dtype=_F64, device=self._device)
        with torch.enable_grad():
            if self._needs_vext():
                with pencil_mode(group):
                    U = U + IonElectron(
                        box, self._slab(self._den, group),
                        self._potential_from_ions(
                            box, cart, self._pencil_local_shape(group)))
            if self._has_ion_ion():
                U = U + self._ion_ion_interaction(box, cart)
            if not U.requires_grad:
                return torch.zeros_like(cart)
            (g,) = _replicated_grad(U, cart, group)
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
        group = _grid_group(self._mesh)
        box0 = self._box_vecs
        vol0 = self.volume("b3")
        frac = self._frac_ion_coords
        den = self._slab(self._den, group)
        energy = self._geometry_energy(group, self._ion_ion_interaction,
                                       of_density=True)
        with torch.enable_grad():
            h = box0.detach().clone().requires_grad_(True)
            E = energy(den * vol0 / volume(h), h, frac @ h)
            (dEdh,) = _replicated_grad(E, h, group)
        stress = dEdh.T @ box0 / vol0
        return 0.5 * (stress + stress.T)

    # ------------------------------------------------------------------
    # second derivatives through the ground state
    # ------------------------------------------------------------------
    # The getters differentiate E(chi*(theta), theta) in float64 from the
    # stored state with ``ops.implicit``, E the energy of
    # ``_geometry_energy`` at the getter's map theta -> (h, cart): the
    # Hessian solves run outside the autograd transforms, preconditioned
    # by ``_cg_precond``.  With a mesh attached, chi is this rank's slab,
    # the energies are replicated values and the solves are SPMD
    # (``implicit.ground_state_hessian(group=)``).

    def _gs_chi(self):
        return safe_sqrt(self._den)

    def _hessian_args(self, group):
        """(chi, precond) of the Hessian solves: the stored ground state's
        chi (this rank's slab with a ``group``) and ``_cg_precond``."""
        return self._slab(self._gs_chi(), group), self._cg_precond(group)

    def pressure(self, units="Ha/b3", requires_grad=False):
        """P = -dE/dV at the stored density (Hellmann-Feynman: no solve)."""
        if requires_grad:
            self._warn_requires_grad("pressure")
        P = self._compute_volume_derivatives(bulk_modulus=False)
        return P * self._pressure_unit(units)

    def enthalpy(self, units="Ha"):
        H = float(self._ene) + self.pressure() * self.volume()
        if units == "Ha":
            return H
        if units == "eV":
            return H * self.eV_per_Ha
        raise ValueError("units must be 'Ha' or 'eV'")

    def bulk_modulus(self, units="Ha/b3", requires_grad=False):
        """K = V d2E/dV2 through the ground state (one Hessian solve)."""
        if requires_grad:
            self._warn_requires_grad("bulk_modulus")
        _, K = self._compute_volume_derivatives(bulk_modulus=True)
        return K * self._pressure_unit(units)

    def _volume_geometry(self):
        """vol -> (h, cart): the stored cell scaled isotropically to vol,
        with its ions."""
        box0, vol0 = self._box_vecs, self.volume("b3")
        frac = self._frac_ion_coords

        def geometry(vol):
            h = box0 * (vol / vol0) ** (1.0 / 3.0)
            return h, frac @ h

        return geometry

    def _volume_energy_fn(self, group=None):
        """(chi, vol) -> energy of the cell scaled isotropically to vol."""
        energy = self._geometry_energy(group, self._ion_ion_interaction)
        geometry = self._volume_geometry()
        return lambda chi, vol: energy(chi, *geometry(vol))

    def _compute_volume_derivatives(self, bulk_modulus=True):
        group = _grid_group(self._mesh)
        vol0 = torch.tensor(self.volume("b3"), dtype=_F64,
                            device=self._device)
        energy = self._volume_energy_fn(group)
        if not bulk_modulus:
            chi0 = self._slab(self._gs_chi(), group)
            with torch.enable_grad():
                vol = vol0.clone().requires_grad_(True)
                (dEdV,) = _replicated_grad(energy(chi0, vol), vol, group)
            return float(-dEdV)
        chi0, pc = self._hessian_args(group)
        dEdV, H = implicit.ground_state_hessian(energy, chi0, vol0,
                                                precond=pc, group=group)
        return float(-dEdV[0]), float(vol0 * H[0, 0])

    def elastic_constants(self, units="Ha/b3"):
        """Birch coefficients C_ijkl = d sigma_ij / d eps_kl through the
        ground state, as the 6x6 Voigt matrix (9 Hessian solves)."""
        return self._compute_elastic_constants() * self._pressure_unit(units)

    def _compute_elastic_constants(self):
        box0 = self._box_vecs
        frac = self._frac_ion_coords
        group = _grid_group(self._mesh)
        energy = self._geometry_energy(group, self._ion_ion_interaction)
        chi0, pc = self._hessian_args(group)
        G0, Hbar = implicit.ground_state_hessian(
            lambda chi, h: energy(chi, h, frac @ h), chi0, box0, precond=pc,
            group=group)
        G0 = G0.reshape(3, 3)

        def stress_of_h(h):
            # the ground-state stress (dEbar/dh)^T h / vol, dEbar/dh to
            # first order in h - h0: its Jacobian at h0 is exact
            G = G0 + (Hbar @ (h - box0).reshape(-1)).reshape(3, 3)
            return G.T @ h / volume(h)

        # D[i, j, k, l] = d sigma_ij / d h_kl
        D = torch.func.jacfwd(stress_of_h)(box0).cpu().numpy()
        h = box0.cpu().numpy()

        def C_block(i, j):
            # C[(ij),(kl)] = sym_kl( sum_m D[i,j,m,k] h[m,l] )
            M = D[i, j].T @ h
            return 0.5 * (M + M.T)

        voigt = [(0, 0), (1, 1), (2, 2), (1, 2), (0, 2), (0, 1)]
        Cs = np.zeros((6, 6))
        for a, (i, j) in enumerate(voigt):
            B = C_block(i, j)
            for b, (k, l) in enumerate(voigt):
                Cs[a, b] = B[k, l]
        Cs = np.triu(Cs) + np.triu(Cs, 1).T  # symmetrised as the reference
        return self._t(Cs)

    def force_constants(self, primitive_ion_indices, units="eV/a2"):
        """Phi[a, j, i, b] = -dF_{p_a, i} / dR_{j, b} through the ground
        state, p_a the primitive ions (3 Hessian solves each)."""
        FC = self._compute_force_constants(primitive_ion_indices)
        if units == "Ha/b2":
            return FC
        if units == "eV/a2":
            return FC * self.eV_per_Ha / self.A_per_b**2
        raise ValueError("units must be 'Ha/b2' or 'eV/a2'")

    def _compute_force_constants(self, primitive_ion_indices):
        box0 = self._box_vecs
        group = _grid_group(self._mesh)
        energy = self._geometry_energy(group, self._ion_ion_interaction)
        chi0, pc = self._hessian_args(group)
        prim = [int(p) for p in primitive_ion_indices]
        rows = [3 * p + i for p in prim for i in range(3)]
        _, Hbar = implicit.ground_state_hessian(
            lambda chi, cart: energy(chi, box0, cart), chi0,
            self._frac_ion_coords @ box0, rows=rows, precond=pc, group=group)
        # Hbar[(p, i), (j, b)] = d2Ebar/dR_pi dR_jb = -dF_pi/dR_jb
        n_ions = self._N_ions
        return Hbar.reshape(len(prim), 3, n_ions, 3).permute(0, 2, 1, 3)

    # ------------------------------------------------------------------
    # differentiable ground-state properties (functional training)
    # ------------------------------------------------------------------

    def _check_functional(self, functional):
        if not any(f is functional for f in self._terms):
            raise ValueError("`functional` must be one of this System's "
                             "terms")

    def gs_property_fn(self, functional=None, property_fn=None):
        """Ground-state properties differentiable with respect to the
        parameters of a trainable term.

        ``functional``: a term of this System with ``apply(params,
        box_vecs, den)`` (a ``KineticFunctional``); its own parameters are
        ignored inside the returned function, the ``params`` argument is
        used instead.  ``property_fn(den, E)``: the quantity of interest
        of the ground-state density [bohr^-3] and total energy [Ha, with
        the ion-ion energy]; default the energy.  Returns ``fn(params)``,
        whose backward takes d(chi*)/d(params) from one adjoint Hessian
        solve at the stored density: call ``optimize_density()`` first,
        with the same parameters."""
        if functional is not None:
            self._check_functional(functional)
        box = self._box_vecs
        chi0 = self._gs_chi()
        cell_energy = self._geometry_energy()

        def energy(chi, params):
            return cell_energy(chi, box, None, params, functional)

        pc = self._cg_precond()
        with torch.no_grad():
            E_ion = (float(self._ion_ion_energy()) if self._has_ion_ion()
                     else 0.0)

        def fn(params):
            chi = implicit.implicit_ground_state(energy, chi0, (params,),
                                                 precond=pc)
            E = energy(chi, params) + E_ion
            if property_fn is None:
                return E
            return property_fn(_chi_map(chi, volume(box), self._N_elec)[0],
                               E)

        return fn

    def gs_volume_property_fn(self, functional, property="pressure"):
        """Pressure (-dE/dV) or bulk modulus (V d2E/dV2), in Ha/bohr^3,
        at the ground state as a differentiable function of a trainable
        term's parameters.  The ground state is the Newton map
        (``implicit.newton_refined_ground_state``), since d(K)/d(params)
        is a third mixed derivative.  Returns ``fn(params) -> scalar``;
        call ``optimize_density()`` first, with the same parameters."""
        if property not in ("pressure", "bulk_modulus"):
            raise ValueError("property must be 'pressure' or 'bulk_modulus'")
        self._check_functional(functional)
        vol0 = self.volume("b3")
        chi0 = self._gs_chi()
        # the ion-ion energy depends on the volume: in P and K, not in
        # their gradients
        cell_energy = self._geometry_energy(ion_ion=self._ion_ion_interaction)
        geometry = self._volume_geometry()

        def energy(chi, vol, params):
            return cell_energy(chi, *geometry(vol), params, functional)

        pc = self._cg_precond()

        def fn(params):
            with torch.enable_grad():
                vol = torch.tensor(vol0, dtype=_F64, device=self._device,
                                   requires_grad=True)
                chi = implicit.newton_refined_ground_state(
                    energy, chi0, (vol, params), precond=pc)
                (dEdV,) = torch.autograd.grad(energy(chi, vol, params), vol,
                                              create_graph=True)
                if property == "pressure":
                    return -dEdV
                (d2,) = torch.autograd.grad(dEdV, vol, create_graph=True)
                return vol0 * d2

        return fn

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

    def save(self, path):
        """Pickle the state snapshot with numpy arrays: the JAX package's
        ``save`` format, so either package loads the other's file."""
        state = {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else v)
                 for k, v in self.state_dict().items()}
        with open(path, "wb") as fh:
            pickle.dump(state, fh)

    def load(self, path):
        """Restore a snapshot written by ``save`` of either package (same
        grid shape and species)."""
        with open(path, "rb") as fh:
            self.load_state_dict(pickle.load(fh))

    # ------------------------------------------------------------------
    # EOS
    # ------------------------------------------------------------------

    def eos_fit(self, f=0.05, N=9, eos="bm", verbose=False, plot=False,
                batched=False, mesh=None, dtype=None, **den_opt_kwargs):
        """Murnaghan / Birch-Murnaghan EOS fit over N volumes within
        +-f of the current one.  Returns (params, errors), params
        (K0 [GPa], K0', E0 [eV/atom], V0 [A^3/atom]).

        The serial scan (the default) sets each volume in turn and
        re-optimizes the density from the last one, with the
        ``den_opt_kwargs`` of ``optimize_density`` over the defaults
        ntol 1e-10, L-BFGS, step 0.1: the System is left at the last
        volume.  ``batched=True`` solves every volume at once, as the
        lanes of one vmapped whole-optimization solve (exact-preconditioned
        TPGD or L-BFGS with ``n_method``; step ``n_step_size``, default
        1.0; ``analytic`` default False) in ``dtype`` (default the
        System's working dtype), each volume's energy evaluated in
        float64 at its end point (see ``_eos_solve_fn``), and leaves the
        System untouched.
        ``dtype`` without ``batched`` raises.  ``mesh``: with a "grid" axis
        wider than one rank (or such a mesh attached by ``set_mesh``) each
        volume's solve runs distributed (``optimize_density(mesh=,
        jit_loop=True)``, ``analytic`` by default where the terms allow),
        which ``batched=True`` rejects; otherwise the batched scan splits
        its volumes over the mesh's "batch" ranks and all-gathers their
        energies."""
        den_opt_inputs = {"ntol": 1e-10, "n_conv_cond_count": 3,
                          "n_method": "LBFGS", "n_step_size": 0.1,
                          "n_maxiter": 1000, "conv_target": "dE",
                          "n_verbose": False, "from_uniform": False}
        den_opt_inputs.update(den_opt_kwargs)
        if dtype is not None and not batched:
            raise ValueError(
                "eos_fit(dtype=...) applies to the batched scan only; the "
                "serial scan runs at the System's own precision")
        if mesh is not None:
            _check_mesh(mesh)

        def wide_grid(m):
            return m is not None and m["grid"].size() > 1

        grid_mesh = mesh if wide_grid(mesh) else (
            self._mesh if wide_grid(self._mesh) else None)
        if grid_mesh is not None and not batched:
            from .models.potentials import supported_terms
            den_opt_inputs.setdefault("jit_loop", True)
            den_opt_inputs["mesh"] = grid_mesh
            den_opt_inputs.setdefault("analytic",
                                      supported_terms(self._terms))
        elif grid_mesh is not None and batched:
            raise ValueError(
                'eos_fit(batched=True) uses a "batch" mesh axis; a "grid" '
                "mesh (pencil-distributed per-volume solves) requires "
                "batched=False")

        pred_v0 = self.volume("a3")
        norm_box_vecs = self.lattice_vectors("a") / pred_v0 ** (1.0 / 3.0)
        vs = pred_v0 * np.linspace(1 - f, 1 + f, N)
        header = "\n{:^22} {:^22}".format("Volume [A^3 per atom]",
                                          "Energy [eV per atom]")
        if batched:
            volumes, energies = self._eos_scan_batched(
                vs, norm_box_vecs.cpu().numpy(), mesh=mesh,
                ntol=den_opt_inputs["ntol"],
                lr=den_opt_kwargs.get("n_step_size", 1.0),
                max_iter=round(den_opt_inputs["n_maxiter"]),
                n_method=den_opt_inputs["n_method"],
                conv_count=den_opt_inputs["n_conv_cond_count"],
                conv_target=den_opt_inputs["conv_target"],
                analytic=den_opt_kwargs.get("analytic", False),
                dtype=dtype)
            if verbose:
                print(header)
                for v, e in zip(volumes, energies):
                    print("{:^22.10f} {:^22.10f}".format(v, e))
        else:
            energies, volumes = [], []
            if verbose:
                print(header)
            for v in vs:
                self.set_lattice(v ** (1.0 / 3.0) * norm_box_vecs, units="a")
                self.optimize_density(**den_opt_inputs)
                vol_per_atom = self.volume("a3") / self._N_ions
                ene_per_atom = self.energy("eV") / self._N_ions
                volumes.append(vol_per_atom)
                energies.append(ene_per_atom)
                if verbose:
                    print("{:^22.10f} {:^22.10f}".format(vol_per_atom,
                                                         ene_per_atom))
        params, err = fit_eos(volumes, energies, eos, plot)
        params[0] *= self.GPa_per_atomic / (self.eV_per_Ha / self.A_per_b**3)
        err[0] *= self.GPa_per_atomic / (self.eV_per_Ha / self.A_per_b**3)
        return params, err

    def _eos_points(self, vs_A3, norm_box_A):
        """The scan's stacked inputs (boxes, v_ext, uniform chi), set up in
        float64 on the System's device (the solve casts them to its
        dtype), and the per-volume ion-ion energies [Ha]."""
        frac = self._frac_ion_coords
        boxes, vexts, chis, E_ions = [], [], [], []
        for v in vs_A3:
            box = self._t((v ** (1.0 / 3.0)) * norm_box_A / self.A_per_b)
            vol = float(volume(box))
            if self._needs_vext():
                v_ext = self._potential_from_ions(box, frac @ box)
            else:
                v_ext = torch.zeros(self._shape, dtype=_F64,
                                    device=self._device)
            chi0 = torch.full(self._shape, np.sqrt(self._N_elec / vol),
                              dtype=_F64, device=self._device)
            E_ii = 0.0
            if self._has_ion_ion():
                Rc, Rd = self._Rc_Rd(box=box)
                shifts = ion_utils.neighbor_shifts(box.cpu().numpy(), Rc)
                with torch.no_grad():
                    E_ii = float(ion_utils.ion_interaction_sum(
                        box, frac @ box, self._charges, Rc, Rd,
                        shifts=shifts))
            boxes.append(box)
            vexts.append(v_ext)
            chis.append(chi0)
            E_ions.append(E_ii)
        return (torch.stack(boxes), torch.stack(vexts), torch.stack(chis),
                E_ions)

    def _eos_energy(self, chi, box, v_ext):
        """The density-terms energy [Ha] of a scan's end point, evaluated
        in float64 from the float64 cell and potential."""
        with torch.no_grad():
            return float(self._chi_energy(chi.to(_F64), box, v_ext,
                                          float(self._N_elec)))

    def _eos_solve_fn(self, n_method, lr, ntol, conv_count, max_iter,
                      analytic, batched=True, dtype=None):
        """The scan's solve: ``solve(chi, box, v_ext) -> (E_density_terms
        [Ha], converged, iterations)`` from the float64 inputs of
        ``_eos_points``: one volume's whole optimization in ``dtype``
        (default the System's working dtype) with the exact preconditioner
        of its cell and the fused analytic (``analytic``) or autograd chi
        gradient.  ``batched``: the arguments carry a leading lane axis
        and the lanes run as one vmapped solve
        (``solvers.*_minimize_lanes``), each lane's result that of the
        serial solve; else one volume through the serial solvers.

        The energy is evaluated in float64 at the end point.  The JAX
        package returns the solver's own energy, which a float32 solve
        evaluates in float32 with float64 accumulation: at 128^3 that
        scatters by up to 4 ueV/atom from run to run, and the fitted K0
        by up to 3e-4, while the float32 end points lie within 0.03
        ueV/atom of the float64 minimum.  In float64 the two agree to
        rounding."""
        N_elec = float(self._N_elec)
        dt = self._dtype if dtype is None else dtype

        def value_and_grad(x, box, v_ext, M, sweep=None):
            if analytic:
                return self._chi_value_and_grad_analytic(x, box, v_ext,
                                                         N_elec, sweep=sweep)
            g, E = torch.func.grad_and_value(self._chi_energy)(
                x, box, v_ext, N_elec)
            return E, g

        def apply_H0(q, box, v_ext, M):
            return spectral_convolution(M, q.reshape(self._shape),
                                        self._shape).reshape(q.shape)

        def kernel(box):
            return self._exact_precond_kernel(box, N_elec)

        kw = dict(lr=lr, ntol=ntol, conv_count=conv_count,
                  max_iter=max_iter, f_scale=EV_PER_HA, skip_iters=2)
        if n_method != "TPGD":
            kw["block"] = 1
        if batched:
            minimize = (solvers.tpgd_minimize_lanes if n_method == "TPGD"
                        else solvers.lbfgs_minimize_lanes)

            def solve(chi, box, v_ext):
                b, v = box.to(dt), v_ext.to(dt)
                M = torch.func.vmap(kernel)(b)
                vg = value_and_grad
                if analytic:   # the terms' host scalars read once a solve
                    from .models.potentials import bind_sweep
                    vg = functools.partial(value_and_grad,
                                           sweep=bind_sweep(self._terms))
                st, its, conv = minimize(vg, chi.to(dt), lanes=(b, v, M),
                                         apply_H0=apply_H0, **kw)
                fs = [self._eos_energy(st.x[i], box[i], v_ext[i])
                      for i in range(chi.shape[0])]
                return fs, conv, its
            return solve

        minimize = (solvers.tpgd_minimize if n_method == "TPGD"
                    else solvers.lbfgs_minimize)

        def solve(chi, box, v_ext):
            b, v = box.to(dt), v_ext.to(dt)
            M = kernel(b)
            if analytic:
                vg, kw_vg = self._analytic_solve_fn(b, v, N_elec, None,
                                                    n_method)
            else:
                vg, kw_vg = (lambda x: value_and_grad(x, b, v, M)), {}
            st, it, conv = minimize(
                vg, chi.to(dt), apply_H0=lambda q: apply_H0(q, b, v, M),
                **kw, **kw_vg)
            return self._eos_energy(st.x, box, v_ext), conv, it
        return solve

    def _eos_scan_batched(self, vs_A3, norm_box_A, ntol, lr, max_iter,
                          n_method="LBFGS", conv_count=3, conv_target="dE",
                          analytic=False, dtype=None, mesh=None):
        """Batched volume scan: every volume a lane of one vmapped solve;
        with a ``mesh`` each "batch" rank solves its block of the volumes
        (``np.array_split`` order) and the results are all-gathered.
        Non-converged volumes are dropped from the fit, with a printed
        warning naming them; fewer than 5 left raises.  Terms with
        ``prepare`` (HC, revHC, YukawaGGA, MGP) are rejected: their ladders
        and tables belong to one cell, and one program for all lanes would
        clip-extrapolate the lanes that leave it.  Returns (volumes
        [A^3/atom], energies [eV/atom]) as lists."""
        for f in self._terms:
            if callable(getattr(getattr(f, "__self__", f), "prepare", None)):
                raise ValueError(
                    f"eos_fit(batched=True) does not support ladder-based "
                    f"term '{term_name(f)}' (per-volume xi ladders can't "
                    f"share one program); use batched=False.")
        if conv_target != "dE":
            raise ValueError(
                "eos_fit(batched=True) supports conv_target='dE' only")
        if n_method not in ("LBFGS", "TPGD"):
            raise ValueError("n_method must be 'LBFGS' or 'TPGD'")
        box_b, vext_b, chi_b, E_ions = self._eos_points(vs_A3, norm_box_A)
        if analytic:
            from .models.potentials import supported_terms
            if not supported_terms(self._terms):
                raise ValueError(
                    "eos_fit(batched=True, analytic=True) requires every "
                    "term to have a fused analytic potential.")
        solve = self._eos_solve_fn(n_method, lr, ntol, conv_count, max_iter,
                                   analytic, dtype=dtype)
        if mesh is None:
            fs, convs, _ = solve(chi_b, box_b, vext_b)
        else:
            fs, convs = self._eos_batch_ranks(solve, mesh, chi_b, box_b,
                                              vext_b)
        vol_per_atom, ene_per_atom, dropped = [], [], []
        for v, f, E_ii, ok in zip(vs_A3, fs, E_ions, convs):
            if ok:
                vol_per_atom.append(float(v) / self._N_ions)
                ene_per_atom.append((f + E_ii) * self.eV_per_Ha
                                    / self._N_ions)
            else:
                dropped.append(float(v))
        if dropped:
            print(f"Warning: batched EOS scan: dropping non-converged "
                  f"volume point(s) {dropped} [A^3] from the fit")
        if len(vol_per_atom) < 5:
            raise RuntimeError(
                f"batched EOS scan: only {len(vol_per_atom)} of "
                f"{len(list(vs_A3))} volume points converged - not enough "
                f"for a 4-parameter EOS fit (raise n_maxiter or loosen ntol)")
        return vol_per_atom, ene_per_atom

    @staticmethod
    def _eos_batch_ranks(solve, mesh, chi_b, box_b, vext_b):
        """The batched solve split over the mesh's "batch" ranks: each
        solves its block of lanes; every rank gets every lane's (energy,
        converged)."""
        import torch.distributed as dist
        if "batch" not in mesh.mesh_dim_names:
            raise ValueError('mesh must have a "batch" axis')
        sub = mesh["batch"]
        blocks = np.array_split(np.arange(chi_b.shape[0]), sub.size())
        mine = blocks[sub.get_local_rank()]
        out = ([], [])
        if len(mine):
            idx = torch.as_tensor(mine, device=chi_b.device)
            fs, convs, _ = solve(chi_b[idx], box_b[idx], vext_b[idx])
            out = (list(fs), list(convs))
        parts = [None] * sub.size()
        dist.all_gather_object(parts, out, group=sub.get_group())
        return ([f for p in parts for f in p[0]],
                [c for p in parts for c in p[1]])

    # ------------------------------------------------------------------
    # geometry optimization
    # ------------------------------------------------------------------

    def optimize_geometry(self, ftol=0.02, stol=0.002, g_conv_cond_count=3,
                          g_method="LBFGSlinesearch", g_step_size=0.1,
                          g_maxiter=1000, g_verbose=False, **den_opt_kwargs):
        """Relax the ionic positions and/or the lattice vectors.

        ``ftol`` (max |F| in eV/A) and ``stol`` (max |sigma| in eV/A^3)
        must both hold for ``g_conv_cond_count`` consecutive steps after
        the third; ``ftol=None`` varies the lattice only, ``stol=None`` the
        positions only.  Each step is one step of the host optimizer
        (``g_method``: 'LBFGSlinesearch', 'LBFGS', 'TPGD' or 'RPROP') on
        the energy at the frozen chi = sqrt(n) of the last density
        optimization (value and gradient by autograd, f64, on the system's
        device), then a density re-optimization with ``den_opt_kwargs``
        (defaults: host-loop L-BFGS, ``ntol=1e-10``).  Returns whether it
        converged.  With ``mesh=`` in ``den_opt_kwargs``, or a mesh
        attached by ``set_mesh``, the steps' gradients, the density
        re-optimizations (which then need ``jit_loop=True``) and the
        force and stress checks run distributed."""
        if ftol is None and stol is None:
            raise ValueError("At least one of stol/ftol must not be None")
        vary_ions = ftol is not None
        vary_cell = stol is not None
        n_frac = 3 * self._N_ions

        def pack():
            parts = []
            if vary_ions:
                parts.append(self._frac_ion_coords.reshape(-1))
            if vary_cell:
                parts.append(self._box_vecs.reshape(-1))
            return torch.cat(parts).cpu().numpy()

        def geometry(x):
            frac, box = self._frac_ion_coords, self._box_vecs
            if vary_ions:
                frac = x[:n_frac].reshape(self._N_ions, 3)
            if vary_cell:
                i = n_frac if vary_ions else 0
                box = x[i:i + 9].reshape(3, 3)
            return frac, box

        def apply(x):
            frac, box = geometry(self._t(x))
            if vary_ions:
                # the ion-ion image table assumes home-cell ions
                self._frac_ion_coords = _wrap(frac)
            if vary_cell:
                self._box_vecs = box
                self._shifts_key = None

        return self._relax(geometry, apply, pack(), ftol, stol,
                           g_conv_cond_count, g_method, g_step_size,
                           g_maxiter, g_verbose, den_opt_kwargs)[0]

    def optimize_parameterized_geometry(self, params, parameterized_geometry,
                                        ftol=0.02, stol=0.002,
                                        g_conv_cond_count=3,
                                        g_method="LBFGSlinesearch",
                                        g_step_size=0.1, g_maxiter=1000,
                                        g_verbose=False, param_string=None,
                                        **den_opt_kwargs):
        """Geometry optimization over a user parameterization
        ``parameterized_geometry(p) -> (box_vecs [bohr], frac)``, written
        with torch ops (it is differentiated by autograd).  The stopping
        rule and ``den_opt_kwargs`` are those of ``optimize_geometry``;
        ``param_string(p) -> str`` extends each verbose line.  Returns
        (converged, optimized params as a float64 tensor on the system's
        device).  A mesh (``mesh=`` or ``set_mesh``) distributes it as in
        ``optimize_geometry``."""
        if ftol is None and stol is None:
            raise ValueError("At least one of stol/ftol must not be None")

        def geometry(p):
            box, frac = parameterized_geometry(p)
            return self._t(frac), self._t(box)

        def apply(p):
            with torch.no_grad():
                frac, box = geometry(self._t(p))
            self._box_vecs = box
            self._frac_ion_coords = _wrap(frac)
            self._shifts_key = None

        p0 = torch.as_tensor(params, dtype=_F64).cpu().numpy().reshape(-1)
        apply(p0)
        self._Eion_cache = None
        self._update_ionic_potential()
        ok, p = self._relax(geometry, apply, p0, ftol, stol,
                            g_conv_cond_count, g_method, g_step_size,
                            g_maxiter, g_verbose, den_opt_kwargs,
                            param_string)
        return ok, self._t(p)

    def _geometry_value_and_grad(self, geometry, held, mesh=None):
        """vg(x) -> (E, dE/dx) of the energy at the frozen chi
        ``held["chi"]`` for the geometry ``geometry(x) -> (frac, box)``
        (the loop sets chi before each step): x goes to the device as an
        f64 tensor, autograd builds and frees its graph inside the call,
        and (E, g) come back as a float and a numpy array.

        The ion-ion cutoff, damping and image table are those of the cell
        at the first call, for the whole relaxation: the JAX package reads
        them from the concrete cell when it traces its jitted objective,
        once per relaxation, and the ion-ion sum depends on them.

        With a ``mesh`` the density terms run on this rank's slab of chi
        (``_geometry_energy``) and every rank returns the same E and
        gradient."""
        group = _grid_group(mesh)
        frozen = []

        def ion_ion(box, cart):
            if not frozen:
                Rc, Rd = self._Rc_Rd()
                frozen.append((Rc, Rd, self._get_shifts(Rc)))
            Rc, Rd, shifts = frozen[0]
            return ion_utils.ion_interaction_sum(
                box, cart, self._charges, Rc, Rd, shifts=shifts)

        energy = self._geometry_energy(group, ion_ion)

        def vg(x):
            with torch.enable_grad():
                xt = self._t(x).requires_grad_(True)
                frac, box = geometry(xt)
                E = energy(self._slab(held["chi"], group), box, frac @ box)
                (g,) = _replicated_grad(E, xt, group)
            if group is None:
                return float(E.detach()), g.cpu().numpy()
            # the host optimizer branches on E: one value for all ranks
            from .parallel.collectives import broadcast_scalar
            return broadcast_scalar(E, group), g.cpu().numpy()

        return vg

    def _relax(self, geometry, apply, x, ftol, stol, conv_count, g_method,
               lr, maxiter, verbose, den_opt_kwargs, param_string=None):
        """The geometry loop shared by both entry points: host optimizer
        step on the frozen-density energy, ``apply(x)`` to the state, cache
        refresh, density re-optimization, stopping rule.  Returns
        (converged, x)."""
        den_opt = {"ntol": 1e-10, "n_conv_cond_count": 3, "n_method": "LBFGS",
                   "n_step_size": 0.1, "n_maxiter": 1000, "conv_target": "dE",
                   "n_verbose": False, "from_uniform": False}
        den_opt.update(den_opt_kwargs)
        mesh = den_opt.get("mesh", self._mesh)
        if mesh is not None:
            _check_mesh(mesh)
            den_opt["mesh"] = mesh
        if g_method in ("LBFGS", "LBFGSlinesearch"):
            opt = _HostLBFGS(lr=lr, history=8, max_iter=6,
                             line_search=g_method == "LBFGSlinesearch")
        elif g_method == "TPGD":
            opt = _HostTPGD(lr=lr)
        elif g_method == "RPROP":
            opt = _HostRprop(lr=lr)
        else:
            raise ValueError("g_method must be 'LBFGSlinesearch', 'LBFGS', "
                             "'RPROP' or 'TPGD'")

        def max_abs(t):
            return float(torch.max(torch.abs(t)))

        self.optimize_density(**den_opt)
        E_prev = self.energy("eV") / self.ion_count()
        if verbose:
            print("{:^7} {:^20} {:^20} {:^20} {:^20}".format(
                "Iter", "E [eV per atom]", "dE [eV per atom]",
                "Max Force [eV/A]", "Max Stress [eV/A^3]"), flush=True)
        held = {}
        vg = self._geometry_value_and_grad(geometry, held, mesh)
        conv_counter = 0
        success_iter = None
        for it in range(1, round(maxiter) + 1):
            held["chi"] = safe_sqrt(self._den)
            x = opt.step(vg, x)
            apply(x)
            # the geometry changed: the cached ion-ion energy is stale
            self._Eion_cache = None
            self._update_ionic_potential()
            self.optimize_density(**den_opt)
            E_new = self.energy("eV") / self.ion_count()
            max_force = max_abs(self.forces("eV/a"))
            max_stress = max_abs(self.stress("eV/a3"))
            if verbose:
                line = "{:^7} {:^20.6f} {:^20.6g} {:^20.6g} {:^20.6g}".format(
                    it, E_new, E_new - E_prev, max_force, max_stress)
                if param_string is not None:
                    line += param_string(self._t(x))
                print(line, flush=True)
            E_prev = E_new
            if it > 3:
                if ftol is None:
                    ok = max_stress < stol
                elif stol is None:
                    ok = max_force < ftol
                else:
                    ok = max_force < ftol and max_stress < stol
                conv_counter = conv_counter + 1 if ok else 0
            if conv_counter == conv_count:
                success_iter = it
                break
        if verbose:
            word = (f"successfully converged in {success_iter} step(s)"
                    if success_iter is not None
                    else f"failed to converge in {maxiter} step(s)")
            print(f"Geometry optimization {word}\n", flush=True)
        return success_iter is not None, x


def _grid_group(mesh):
    """The "grid" process group of ``mesh``; None for no mesh (serial)."""
    if mesh is None:
        return None
    from .parallel.mesh import grid_group
    return grid_group(mesh)[0]


def _replicated_grad(E, inputs, group):
    """``torch.autograd.grad`` of the energy E with respect to ``inputs``
    that every rank holds whole (the cell, the ions, theta).  On a
    ``group`` E is a replicated value: each rank differentiates its share
    and the gradient is the psum of the parts (``parallel/collectives.py``).
    Serially (``group`` None) the plain gradient."""
    if group is None:
        return torch.autograd.grad(E, inputs)
    from .parallel.collectives import psum, rank_share
    return tuple(psum(g, group)
                 for g in torch.autograd.grad(rank_share(E, group), inputs))


def _check_mesh(mesh):
    """A mesh must be a ``DeviceMesh`` with a "grid" axis."""
    if "grid" not in (getattr(mesh, "mesh_dim_names", None) or ()):
        raise ValueError('mesh must be a DeviceMesh with a "grid" axis '
                         '(parallel.make_mesh)')


def _tensor_token(t, pins):
    """A tensor's identity, version, storage address, dtype and device
    (``nn.Module.to`` swaps a parameter's data without a new version);
    the tensor and a view of its storage go to ``pins``."""
    pins.append((t, t.detach()))
    return (id(t), t._version, t.data_ptr(), t.dtype, t.device)


def _is_model_function(f):
    """Whether ``f`` is one of the port's term functions, a module-level
    function of ``models`` (no state beyond its arguments)."""
    return (isinstance(f, types.FunctionType)
            and (f.__module__ or "").startswith(_MODELS)
            and getattr(sys.modules.get(f.__module__), f.__name__, None)
            is f)


def _wrap(frac):
    """Fractional coordinates into [0, 1), wrapped twice: a tiny negative
    maps -1e-16 -> 1.0 -> 0.0."""
    frac = frac - torch.floor(frac)
    return frac - torch.floor(frac)


# ----------------------------------------------------------------------
# host-side optimizers for the few geometry degrees of freedom (<= 3N+9),
# in float64 numpy; the heavy work is inside the value-and-gradient call
# ----------------------------------------------------------------------

def _cubic_minimizer(a, fa, ga, b, fb, gb):
    """Minimizer of the cubic interpolating (a, fa, ga) and (b, fb, gb),
    clipped to the [a, b] interval (Nocedal & Wright eq. 3.59)."""
    lo, hi = (a, b) if a <= b else (b, a)
    d1 = ga + gb - 3.0 * (fa - fb) / (a - b)
    disc = d1 * d1 - ga * gb
    if disc < 0.0 or a == b:
        return 0.5 * (lo + hi)
    d2 = np.sqrt(disc) * np.sign(b - a)
    t = b - (b - a) * ((gb + d2 - d1) / (gb - ga + 2.0 * d2))
    if not np.isfinite(t):
        return 0.5 * (lo + hi)
    return float(min(max(t, lo), hi))


class _HostLBFGS:
    """L-BFGS (history 8) with a strong-Wolfe cubic-interpolation line
    search (Nocedal & Wright, alg. 3.5/3.6) and a trust-region cap on
    |t d|_inf, because the frozen-density geometry objective is unbounded
    below under cell collapse."""

    def __init__(self, lr=0.1, history=8, max_iter=6, line_search=True,
                 max_step=0.2, c1=1e-4, c2=0.9):
        self.lr = lr
        self.history = history
        self.max_iter = max_iter
        self.line_search = line_search
        self.max_step = max_step  # trust region: cap |t d|_inf per iteration
        self.c1 = c1              # Armijo (sufficient-decrease) constant
        self.c2 = c2              # curvature (strong-Wolfe) constant
        self.S, self.Y = [], []
        self.n_iter = 0
        self._prev = None  # (x, g)

    def _direction(self, g):
        if not self.S:
            return -g
        q = -g.copy()
        al = []
        rho = [1.0 / np.dot(y, s) for s, y in zip(self.S, self.Y)]
        for i in range(len(self.S) - 1, -1, -1):
            a = rho[i] * np.dot(self.S[i], q)
            al.append(a)
            q -= a * self.Y[i]
        al = al[::-1]
        ys = np.dot(self.Y[-1], self.S[-1])
        H0 = ys / np.dot(self.Y[-1], self.Y[-1])
        r = H0 * q
        for i in range(len(self.S)):
            be = rho[i] * np.dot(self.Y[i], r)
            r += (al[i] - be) * self.S[i]
        return r

    def step(self, vg, x0):
        x = np.asarray(x0, dtype=np.float64)
        f, g = vg(x)
        f, g = float(f), np.asarray(g, dtype=np.float64)
        for _ in range(self.max_iter):
            if self._prev is not None:
                xp, gp = self._prev
                s = x - xp
                y = g - gp
                ys = np.dot(y, s)
                # curvature filter, plus a floor on the step's scale:
                # machine-epsilon steps give noise-dominated y that would
                # poison every later two-loop direction
                s_ok = np.max(np.abs(s)) > 1e-12 * (1.0 + np.max(np.abs(x)))
                if ys > 1e-10 * np.dot(s, s) and s_ok:
                    self.S.append(s)
                    self.Y.append(y)
                    if len(self.S) > self.history:
                        self.S.pop(0)
                        self.Y.pop(0)
            d = self._direction(g)
            if np.max(np.abs(d)) <= 1e-13 * (1.0 + np.max(np.abs(x))):
                break  # converged to machine precision
            gtd = np.dot(g, d)
            if gtd > 0:  # not a descent direction: reset
                d, gtd = -g, -np.dot(g, g)
            if self.n_iter == 0:
                t = min(1.0, 1.0 / max(np.sum(np.abs(g)), 1e-300)) * self.lr
            elif self.line_search and self.S:
                # with curvature memory the direction is quasi-Newton:
                # start the search at the unit step
                t = 1.0
            else:
                t = self.lr
            d_inf = np.max(np.abs(d))
            if t * d_inf > self.max_step:
                t = self.max_step / d_inf
            self._prev = (x.copy(), g.copy())
            if self.line_search:
                t_cap = self.max_step / d_inf
                t, f, g = self._wolfe_cubic(vg, x, f, g, d, min(t, t_cap),
                                            t_cap)
                x = x + t * d
            else:
                x = x + t * d
                f, g = vg(x)
                f, g = float(f), np.asarray(g, dtype=np.float64)
            self.n_iter += 1
        return x

    def _wolfe_cubic(self, vg, x, f0, g0, d, t, t_cap):
        """Strong-Wolfe line search with cubic interpolation: bracketing,
        then zoom.  Returns (t, f(x + t d), grad(x + t d))."""
        c1, c2 = self.c1, self.c2
        gtd0 = float(np.dot(g0, d))

        def ev(t):
            f_t, g_t = vg(x + t * d)
            return float(f_t), np.asarray(g_t, dtype=np.float64)

        t_prev, f_prev, g_prev, gtd_prev = 0.0, f0, g0, gtd0
        bracket = None
        for i in range(10):
            f_t, g_t = ev(t)
            gtd_t = float(np.dot(g_t, d))
            if (not np.isfinite(f_t)) or f_t > f0 + c1 * t * gtd0 or \
                    (i > 0 and f_t >= f_prev):
                bracket = (t_prev, f_prev, g_prev, gtd_prev, t, f_t, g_t,
                           gtd_t)
                break
            if abs(gtd_t) <= -c2 * gtd0:
                return t, f_t, g_t          # strong Wolfe satisfied
            if gtd_t >= 0.0:
                bracket = (t, f_t, g_t, gtd_t, t_prev, f_prev, g_prev,
                           gtd_prev)
                break
            if t >= t_cap:
                return t, f_t, g_t          # trust-region boundary
            t_prev, f_prev, g_prev, gtd_prev = t, f_t, g_t, gtd_t
            t = min(2.0 * t, t_cap)
        if bracket is None:
            return t_prev, f_prev, g_prev

        # zoom: lo satisfies Armijo with the lower f; hi is the other end
        t_lo, f_lo, g_lo, gtd_lo, t_hi, f_hi, g_hi, gtd_hi = bracket
        for _ in range(10):
            t = _cubic_minimizer(t_lo, f_lo, gtd_lo, t_hi, f_hi, gtd_hi)
            span = abs(t_hi - t_lo)
            # keep a minimum fraction away from the endpoints
            lo_end, hi_end = min(t_lo, t_hi), max(t_lo, t_hi)
            t = min(max(t, lo_end + 0.1 * span), hi_end - 0.1 * span)
            f_t, g_t = ev(t)
            gtd_t = float(np.dot(g_t, d))
            if (not np.isfinite(f_t)) or f_t > f0 + c1 * t * gtd0 or \
                    f_t >= f_lo:
                t_hi, f_hi, g_hi, gtd_hi = t, f_t, g_t, gtd_t
            else:
                if abs(gtd_t) <= -c2 * gtd0:
                    return t, f_t, g_t
                if gtd_t * (t_hi - t_lo) >= 0.0:
                    t_hi, f_hi, g_hi, gtd_hi = t_lo, f_lo, g_lo, gtd_lo
                t_lo, f_lo, g_lo, gtd_lo = t, f_t, g_t, gtd_t
            if span < 1e-12:
                break
        return t_lo, f_lo, g_lo


class _HostTPGD:
    """Barzilai-Borwein two-point gradient descent."""

    def __init__(self, lr=0.1):
        self.lr = lr
        self._prev = None

    def step(self, vg, x0):
        x = np.asarray(x0, dtype=np.float64)
        f, g = vg(x)
        g = np.asarray(g, dtype=np.float64)
        if self._prev is None:
            alpha = self.lr
        else:
            xp, gp = self._prev
            dx, dg = x - xp, g - gp
            den = np.dot(dx, dg)
            alpha = np.dot(dx, dx) / den if den != 0 else self.lr
            if alpha <= 0:
                alpha = self.lr
        self._prev = (x.copy(), g.copy())
        return x - alpha * g


class _HostRprop:
    """Resilient backpropagation (sign-based steps), the counterpart of
    ``torch.optim.Rprop`` for the geometry vector."""

    def __init__(self, lr=0.1, etas=(0.5, 1.2), step_sizes=(1e-6, 50.0)):
        self.lr = lr
        self.eta_minus, self.eta_plus = etas
        self.step_min, self.step_max = step_sizes
        self._step = None
        self._g_prev = None

    def step(self, vg, x0):
        x = np.asarray(x0, dtype=np.float64)
        f, g = vg(x)
        g = np.asarray(g, dtype=np.float64)
        if self._step is None:
            self._step = np.full_like(x, self.lr)
            self._g_prev = np.zeros_like(x)
        sign = g * self._g_prev
        self._step = np.where(
            sign > 0, np.minimum(self._step * self.eta_plus, self.step_max),
            np.where(sign < 0,
                     np.maximum(self._step * self.eta_minus, self.step_min),
                     self._step))
        g_eff = np.where(sign < 0, 0.0, g)
        self._g_prev = g_eff
        return x - np.sign(g_eff) * self._step
