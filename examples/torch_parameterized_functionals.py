"""Training parameterized kinetic functionals with the PyTorch/CUDA port
(the port's version of examples/parameterized_functionals.py).

1. Fit a Pauli-Gaussian functional's (mu, beta, lambda, sigma) so its
   kinetic potential matches the Wang-Teter one on an optimized fcc-Al
   density.
2. Same task with the MLP NeuralNetworkFunctional: gradients of the loss
   flow through the functional derivative (a second-order autodiff).
3. GROUND-STATE training: fit PG so its re-optimized ground-state energy
   matches the WT one; gradients flow THROUGH the density optimizer via
   ``System.gs_property_fn`` (one adjoint Hessian solve per epoch).

Run:  python examples/torch_parameterized_functionals.py [--device cpu]
(the default device is the first CUDA card).
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))  # repo-root run

import torch

from professad_tpu_torch.system import System
from professad_tpu_torch.models import (IonIon, IonElectron, Hartree,
                                        WangTeter, PerdewBurkeErnzerhof,
                                        PauliGaussian)
from professad_tpu_torch.models.neural import NeuralNetworkFunctional
from professad_tpu_torch.ops.autodiff import get_functional_derivative
from professad_tpu_torch.utils.crystal import get_cell

POT = os.path.join(os.path.dirname(__file__), "..", "tests", "potentials",
                   "al.gga.recpot")


def wt_reference(device=None, n=20):
    """The optimized fcc-Al WT + PBE system: (system, density, box in
    bohr, box and fractional coordinates as built)."""
    box_vecs, frac = get_cell("fcc", vol_per_atom=16.9, device=device)
    terms = [IonIon, IonElectron, Hartree, WangTeter, PerdewBurkeErnzerhof]
    system = System(box_vecs, (n, n, n), [["Al", POT, frac]], terms,
                    units="a", coord_type="fractional", device=device)
    system.optimize_density(ntol=1e-9)
    return system, system.density(), system.lattice_vectors("b"), \
        (box_vecs, frac)


def make_loss(functional, bv, den, v_target):
    """Mean squared error of the functional's kinetic potential against
    ``v_target``, differentiable with respect to ``params``."""
    def loss(params):
        v_pred = get_functional_derivative(
            bv, den, lambda b, n: functional.apply(params, b, n))
        return torch.mean((v_pred - v_target) ** 2)
    return loss


def train(functional, loss, epochs, every):
    """``epochs`` optimizer steps; the loss before each."""
    losses = []
    for epoch in range(epochs):
        losses.append(float(functional.update_params(loss)))
        if epoch % every == 0:
            print(f"  epoch {epoch:3d}  loss {losses[-1]:.3e}")
    return losses


def main(device=None, n=20, gs_n=14, pg_epochs=50, nn_epochs=100,
         gs_epochs=6):
    """Run the three trainings; returns their losses and the checkpoint
    check."""
    out = {}
    system, den, bv, (box_vecs, frac) = wt_reference(device, n)
    # training target: the WT kinetic potential on this density
    v_target = get_functional_derivative(bv, den, WangTeter)

    # ---- 1. Pauli-Gaussian ----------------------------------------------
    pg = PauliGaussian()
    pg.set_device(den.device)
    print("training PauliGaussian (mu, beta, lambda, sigma):")
    out["pg_losses"] = train(pg, make_loss(pg, bv, den, v_target),
                             pg_epochs, 10)
    out["pg_params"] = {k: v.item() for k, v in pg.params.items()}
    print({k: round(v, 4) for k, v in out["pg_params"].items()})

    # ---- 2. MLP functional ----------------------------------------------
    nn = NeuralNetworkFunctional([16, 16])
    nn.set_device(den.device)
    loss_nn = make_loss(nn, bv, den, v_target)
    print("training NeuralNetworkFunctional([16, 16]):")
    out["nn_losses"] = train(nn, loss_nn, nn_epochs, 20)

    # checkpoint round trip
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "nn_functional.pkl")
        nn.save(path)
        nn2 = NeuralNetworkFunctional.load(path)
    nn2.set_device(den.device)
    out["checkpoint_ok"] = bool(loss_nn(nn2.params) == loss_nn(nn.params))
    print("checkpoint round-trip OK:", out["checkpoint_ok"])

    # ---- 3. ground-state training ----------------------------------------
    # target: the WT ground-state energy; trainable: PG, whose ground state
    # is RE-OPTIMIZED each epoch and differentiated through (implicit
    # function theorem)
    E_target = system.energy("Ha")
    pg_gs = PauliGaussian()
    pg_gs.set_device(den.device)
    sys_pg = System(box_vecs, (gs_n,) * 3, [["Al", POT, frac]],
                    [IonIon, IonElectron, Hartree, pg_gs,
                     PerdewBurkeErnzerhof],
                    units="a", coord_type="fractional", device=device)
    print("ground-state energy training (target = WT energy):")
    losses = []
    for epoch in range(gs_epochs):
        # re-converge the density at the current params, then take the
        # implicit gradient
        sys_pg.optimize_density(ntol=1e-9, n_maxiter=2000)
        gs_energy = sys_pg.gs_property_fn(pg_gs)
        losses.append(float(pg_gs.update_params(
            lambda p: pg_gs.scalar_error(E_target, gs_energy(p)))))
        print(f"  epoch {epoch:3d}  loss {losses[-1]:.3e}  "
              f"E {sys_pg.energy('Ha'):.6f} vs target {E_target:.6f}")
    out["gs_losses"] = losses
    out["gs_params"] = {k: v.item() for k, v in pg_gs.params.items()}
    print({k: round(v, 4) for k, v in out["gs_params"].items()})
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda:0)")
    main(parser.parse_args().device)
