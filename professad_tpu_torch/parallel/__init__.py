"""Multi-device runs on ``torch.distributed``: process groups and meshes
(``mesh.py``), differentiable collectives (``collectives.py``), and the
pencil FFTs with the distributed energy, gradient and solver
(``pfft.py``).  ``dryrun.py`` runs the distributed paths once, e.g. under
``torchrun --nproc-per-node N``."""

from .mesh import (init_process_group, make_mesh, auto_mesh_shape,
                   grid_group, grid_sharding, flat_sharding,
                   batch_grid_sharding, replicated, shard_density,
                   gather_grid)
from .collectives import (all_to_all, psum, rank_share, axis_index,
                          axis_size, all_gather, broadcast_scalar)
from .pfft import (prfftn, pirfftn, prfftn_dc, pirfftn_dc, pwavevecs, pconv,
                   pconv_dc,
                   pmean, pqmean, pwmean, penergy_wt_pbe,
                   pvalue_and_potential_wt_pbe, pchi_value_and_grad,
                   pchi_value_and_grad_analytic, penergy_terms,
                   aux_pencil_specs, pchi_value_and_grad_terms,
                   pencil_tpgd_minimize)

__all__ = ["init_process_group", "make_mesh", "auto_mesh_shape",
           "grid_group", "grid_sharding", "flat_sharding",
           "batch_grid_sharding", "replicated", "shard_density",
           "gather_grid", "all_to_all", "psum", "rank_share", "axis_index",
           "axis_size", "all_gather", "broadcast_scalar", "prfftn",
           "pirfftn", "prfftn_dc", "pirfftn_dc", "pwavevecs", "pconv", "pconv_dc",
           "pmean", "pqmean", "pwmean", "penergy_wt_pbe",
           "pvalue_and_potential_wt_pbe", "pchi_value_and_grad",
           "pchi_value_and_grad_analytic", "penergy_terms",
           "aux_pencil_specs", "pchi_value_and_grad_terms",
           "pencil_tpgd_minimize"]
