"""Process groups, device meshes and slab placement for multi-device runs.

PyTorch counterpart of ``professad_tpu/parallel/mesh.py``.  The JAX package
drives every device from one controller (``shard_map`` over a
``jax.sharding.Mesh``); the port runs SPMD, the ``torchrun`` model: one
process per device, every rank building the same ``System`` and calling the
same methods.  The mesh has the JAX package's two axes:

* **grid**: the slab decomposition of the 3-D grid along axis 0 (its
  spectra along axis 1, the k-pencils of ``parallel.pfft``);
* **batch**: independent systems (the volumes of an EOS scan), no
  communication.

``init_process_group`` starts the group: NCCL with one ``cuda:{local_rank}``
device per rank by default, gloo only when the caller asks for the CPU.  It
never falls back from one to the other.  ``make_mesh`` builds the
("batch", "grid") ``DeviceMesh`` over the started group.  The slab helpers
stand in for the JAX package's ``NamedSharding`` placements: they return
this rank's part of a whole tensor that every rank holds.
"""

import os

import torch
import torch.distributed as dist

__all__ = ["init_process_group", "make_mesh", "auto_mesh_shape",
           "grid_group", "grid_sharding", "flat_sharding",
           "batch_grid_sharding", "replicated", "shard_density",
           "gather_grid"]


def init_process_group(rank=None, world_size=None, init_method=None,
                       device=None, timeout=None):
    """Start the default process group and return this rank's device.

    Without arguments the ``torchrun`` environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) is
    read.  Explicit ``rank``, ``world_size`` and ``init_method`` (e.g.
    ``"file:///tmp/rdv"`` or ``"tcp://localhost:29500"``) start a group
    without ``torchrun``.  ``device=None`` means NCCL on ``cuda:{local
    rank}`` (one card per rank) and raises without CUDA; ``device="cpu"``
    means gloo on the CPU.  ``timeout``: seconds a collective may wait
    (the backend's default if None)."""
    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if init_method is None:
        init_method = "env://"
    if device is not None and torch.device(device).type == "cpu":
        backend, dev = "gloo", torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_process_group: NCCL needs a CUDA device; pass "
                "device='cpu' for gloo ranks on the CPU")
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = (torch.device("cuda", local) if device is None
               else torch.device(device))
        torch.cuda.set_device(dev)
        backend = "nccl"
    kw = dict(device_id=dev) if backend == "nccl" else {}
    if timeout is not None:
        import datetime
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kw)
    return dev


def auto_mesh_shape(n_devices, batch=1):
    """Split ``n_devices`` into (batch, grid) axes; ``batch`` divides n."""
    if n_devices % batch != 0:
        raise ValueError(f"batch axis {batch} must divide n_devices "
                         f"{n_devices}")
    return (batch, n_devices // batch)


def make_mesh(n_devices=None, batch=1):
    """The ("batch", "grid") ``DeviceMesh`` over the started process group
    (one rank per device).  ``n_devices`` defaults to, and must equal, the
    group's size; ``batch`` is the size of the data-parallel axis (1: a
    pure spatial decomposition).  Collective: every rank calls it."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"make_mesh: n_devices {n_devices} must equal the "
                         f"process group's size {world} (one rank per "
                         f"device)")
    shape = auto_mesh_shape(n_devices, batch)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=("batch", "grid"))


def grid_group(mesh):
    """(process group, size, this rank's index) of the mesh's "grid"
    axis."""
    sub = mesh["grid"]
    return sub.get_group(), sub.size(), sub.get_local_rank()


def _chunk(x, axis, size, index):
    n = x.shape[axis]
    if n % size:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} does not divide "
                         f"by the mesh axis size {size}")
    step = n // size
    return x.narrow(axis, index * step, step)


def grid_sharding(mesh):
    """Placement of a (n0, n1, n2) field: ``x -> this rank's axis-0
    slab``."""
    _, size, index = grid_group(mesh)
    return lambda x: _chunk(x, 0, size, index)


def flat_sharding(mesh):
    """Placement of a flat chi vector (row-major flattening of the grid):
    this rank's contiguous block, the flattening of its slab."""
    _, size, index = grid_group(mesh)
    return lambda x: _chunk(x.reshape(-1), 0, size, index)


def batch_grid_sharding(mesh):
    """Placement of a (batch, n0, n1, n2) stack: this rank's block of the
    batch axis, and of that its axis-1 (grid axis-0) slabs."""
    b = mesh["batch"]
    _, size, index = grid_group(mesh)
    return lambda x: _chunk(_chunk(x, 0, b.size(), b.get_local_rank()),
                            1, size, index)


def replicated(mesh):
    """Placement of a tensor every rank holds whole (cells, scalars, small
    tables)."""
    return lambda x: x


def shard_density(den, mesh):
    """This rank's axis-0 slab of a 3-D density; axis 0 must divide by the
    "grid" axis size."""
    return grid_sharding(mesh)(den)


def gather_grid(x_local, mesh):
    """The whole field from every rank's axis-0 slab (an all-gather over
    the "grid" axis; collective)."""
    from .collectives import all_gather
    group, _, _ = grid_group(mesh)
    return all_gather(x_local, 0, group)
