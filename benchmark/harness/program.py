"""The system under test, driven through the public ``System`` of
``professad_tpu_torch`` only: the System a configuration describes, and
one request served through ``place_ions`` / ``optimize_density`` /
``forces`` or ``set_lattice`` / ``eos_fit``.  Each public call is wrapped
in a span of the benchmark's own (``Spans``)."""

import contextlib
import io

import torch

from .spec import ideal_cell, ion_ion_rc_bohr, ntol_eV, recpot_path

DTYPES = {"float32": torch.float32, "float64": torch.float64}
# the solver settings the batched EOS scan reads
EOS_KEYS = ("ntol", "n_method", "n_step_size", "n_maxiter",
            "n_conv_cond_count", "analytic")


def build_system(config, device):
    from professad_tpu_torch import System
    from professad_tpu_torch.models import (
        IonIon, IonElectron, Hartree, WangTeter, WangTeterStyleFunctional,
        PerdewBurkeErnzerhof)
    terms = []
    for t in config["terms"]:
        if t == "WangTeterExp":
            f = WangTeterStyleFunctional((5.0 / 6.0, 5.0 / 6.0, torch.exp))
            terms.append(f.to(device).forward)
        else:
            terms.append({"IonIon": IonIon, "IonElectron": IonElectron,
                          "Hartree": Hartree, "WangTeter": WangTeter,
                          "PBE": PerdewBurkeErnzerhof}[t])
    box, frac = ideal_cell(config)
    dtype = DTYPES[config["dtype"]]
    return System(box, tuple(config["grid"]),
                  [[config["species"], recpot_path(config), frac]], terms,
                  units="a", coord_type="fractional",
                  Rc=ion_ion_rc_bohr(config),
                  pme_order=config.get("pme_order"), device=device,
                  dtype=dtype)


def solver_kwargs(config, n_ions):
    kw = dict(config["solver"])
    kw["ntol"] = ntol_eV(config, n_ions)
    return kw


class Server:
    """Serves one kind of request on one System; keeps the answers of the
    requests it is told to keep, for the judge."""

    def __init__(self, system, config, mix, spans):
        self.s = system
        self.config = config
        self.mix = mix
        self.spans = spans
        self.kw = solver_kwargs(config, system.ion_count())

    def ground_state(self, cart_A, from_uniform, max_iter=None, keep=False):
        s, kw = self.s, dict(self.kw)
        if max_iter is not None:
            kw["n_maxiter"] = max_iter
        with self.spans("place_ions"):
            s.place_ions(cart_A, coord_type="cartesian", units="a")
        with self.spans("optimize_density"):
            n_it, conv = s.optimize_density(from_uniform=from_uniform, **kw)
        with self.spans("forces"):
            F = s.forces(units="eV/a").cpu().numpy()
        E = s.energy("eV")
        answer = {"iters": int(n_it), "converged": bool(conv), "E_eV": E,
                  "F_eV_A": F}
        if keep:
            answer["density"] = s.density().cpu()
        return answer

    def eos(self, c_over_a, max_iter=None):
        s = self.s
        kw = {k: v for k, v in self.kw.items() if k in EOS_KEYS}
        if max_iter is not None:
            kw["n_maxiter"] = max_iter
        box, _ = ideal_cell(self.config, c_over_a=c_over_a)
        with self.spans("set_lattice"):
            s.set_lattice(box, units="a")
        out = io.StringIO()
        with self.spans("eos_fit"), contextlib.redirect_stdout(out):
            params, _ = s.eos_fit(
                f=self.mix["f"], N=self.mix["N"], batched=True,
                dtype=DTYPES[self.config["dtype"]], verbose=True, **kw)
        table = [[float(v) for v in ln.split()]
                 for ln in out.getvalue().splitlines()
                 if len(ln.split()) == 2 and _floats(ln)]
        return {"c_over_a": c_over_a, "params": [float(p) for p in params],
                "table": table, "printed": out.getvalue(),
                "converged": len(table) == self.mix["N"]}


def _floats(line):
    try:
        [float(v) for v in line.split()]
        return True
    except ValueError:
        return False

