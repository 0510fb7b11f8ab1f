"""Meshes over ``torch.distributed`` (the port of ``repro/launch/mesh.py``).

The reference builds a ``jax.sharding.Mesh`` over the devices one process
sees, and GSPMD partitions every program over it.  PyTorch has no
partitioner, so the port runs SPMD: one process (rank) per mesh position,
each holding its own shard, all in one process group.  :class:`Mesh` is
the view of that group that the sharding rules and the collectives read:
``shape`` (axis name -> size, as ``jax.sharding.Mesh.shape``),
``axis_names``, and a process group per axis, from
``torch.distributed.device_mesh.init_device_mesh`` with
``mesh_dim_names=("data", "model")``.

Ranks come from ``torchrun`` (``torchrun --nproc-per-node 2 script.py``,
which sets the rendezvous environment) or from :func:`spawn`.  Backends:

* ``"nccl"`` -- one card per rank (the four-card layout);
* ``"gloo"`` -- CPU ranks, or several ranks that share one card.  NCCL
  refuses two ranks on one device; gloo reduces CUDA tensors only through
  host memory, which ``runtime.collectives`` does openly.

A :class:`DryMesh` is a mesh of any shape -- ``(16, 16)`` or ``(2, 16,
16)`` -- with no process group behind it: one rank's coordinates, given
(rank 0's by default), and axes whose collectives return placeholders
(``runtime.collectives``, backend ``"dry"``).  The dry run
(``launch.dryrun``) runs one rank's program on it, on ``"meta"`` tensors
or on the card.

Defined as functions: importing this module starts no process group.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import tempfile
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.runtime.collectives import DRY

AXES = ("data", "model")

# how long a spawned rank waits in a collective for the others
RANK_TIMEOUT_S = 600


@dataclasses.dataclass
class Mesh:
    """A (data, model) mesh over the ranks of the default process group."""

    shape: dict                    # axis name -> size, in mesh order
    device_mesh: object            # torch.distributed.device_mesh.DeviceMesh
    backend: str
    device: torch.device           # where this rank's tensors live

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group(self, axis):
        """The process group of ``axis`` that holds this rank; a tuple of
        axis names: their ranks as one group (made once, by every rank)."""
        if not isinstance(axis, tuple):
            return self.device_mesh.get_group(axis)
        groups = self.__dict__.setdefault("_flat_groups", {})
        if axis not in groups:
            groups[axis] = self.device_mesh[axis]._flatten("_".join(axis)).get_group()
        return groups[axis]

    def axis_rank(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.device_mesh.get_local_rank(axis)


@dataclasses.dataclass
class DryMesh(Mesh):
    """A mesh of any shape with no process group: one rank's view of it
    (``coords``: axis name -> this rank's coordinate)."""

    coords: dict = dataclasses.field(default_factory=dict)

    def group(self, axis):
        raise RuntimeError("a dry mesh has no process groups; its collectives "
                           "return placeholders (runtime.collectives)")

    def axis_rank(self, axis: str) -> int:
        return self.coords[axis]


def make_dry_mesh(shape, axes, *, coords: Optional[dict] = None, device="meta") -> DryMesh:
    """A :class:`DryMesh` of ``shape`` over ``axes``, seen from the rank at
    ``coords`` (default: every coordinate 0) with its tensors on
    ``device``."""
    coords = {a: 0 for a in axes} if coords is None else dict(coords)
    for a, n in zip(axes, shape):
        if not 0 <= coords.get(a, -1) < n:
            raise ValueError(f"coordinate {coords.get(a)} of axis {a!r} outside 0..{n - 1}")
    return DryMesh(dict(zip(axes, shape)), None, DRY, torch.device(device), coords)


def _one_rank_group(backend: str) -> None:
    """A real one-rank process group (``MeshConfig(enable=True)`` at
    tp=dp=1 in a process nothing launched as a rank)."""
    store = os.path.join(tempfile.mkdtemp(prefix="repro_torch_pg_"), "store")
    dist.init_process_group(backend, init_method=f"file://{store}", world_size=1, rank=0)


def _make_mesh(shape, axes, *, backend: Optional[str] = None, device=None) -> Mesh:
    """A mesh of ``shape`` over the default process group, which must have
    exactly ``prod(shape)`` ranks (a one-rank group is started here when
    ``prod(shape) == 1`` and none exists)."""
    need = math.prod(shape)
    if not dist.is_initialized():
        if need != 1:
            raise ValueError(
                f"mesh shape {dict(zip(axes, shape))} needs {need} ranks but no "
                "process group is initialised; launch the ranks with "
                f"`torchrun --nproc-per-node {need} ...` or "
                f"repro_torch.launch.mesh.spawn(fn, {need}, backend=...), and build "
                "the mesh inside each rank")
        _one_rank_group(backend or ("nccl" if torch.cuda.is_available() else "gloo"))
    have = dist.get_world_size()
    if need != have:
        raise ValueError(
            f"mesh shape {dict(zip(axes, shape))} needs {need} ranks but the "
            f"process group has {have}; launch exactly {need} ranks")
    pg_backend = str(dist.get_backend())
    if backend is not None and backend != pg_backend:
        raise ValueError(f"mesh asks for backend {backend!r} but the process group "
                         f"runs {pg_backend!r}")
    from torch.distributed.device_mesh import init_device_mesh

    # gloo groups carry CPU tensors; CUDA tensors are staged through the
    # host by runtime.collectives, so the device mesh itself is a CPU mesh
    dm = init_device_mesh("cuda" if pg_backend == "nccl" else "cpu", tuple(shape),
                          mesh_dim_names=tuple(axes))
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if pg_backend == "nccl" else torch.device("cpu"))
    if dist.get_rank() == 0:
        print(f"[mesh] {dict(zip(axes, shape))} over {need} rank(s), backend "
              f"{pg_backend}, rank 0 on {device}", flush=True)
    return Mesh(dict(zip(axes, shape)), dm, pg_backend, torch.device(device))


def make_production_mesh(*, multi_pod: bool = False, backend: str = "nccl", device=None,
                         dry: bool = False):
    """The reference's production layouts: (16, 16) or (2, 16, 16) ranks.
    ``dry=True``: a :class:`DryMesh` of that layout (no ranks started),
    seen from rank 0, with its tensors on ``device`` (default
    ``"meta"``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else AXES
    if dry:
        return make_dry_mesh(shape, axes, device=device or "meta")
    return _make_mesh(shape, axes, backend=backend, device=device)


def make_host_mesh(data: int = 1, model: int = 1, *, backend: Optional[str] = None,
                   device=None) -> Mesh:
    """A (data, model) mesh over the launched ranks -- tests and examples."""
    return _make_mesh((data, model), AXES, backend=backend, device=device)


def rank_device(backend: str, rank: int, shared_card: bool = False) -> torch.device:
    """Where rank ``rank`` runs: ``cuda:rank`` when there are cards enough,
    ``cuda:0`` when the caller asks for the shared-card layout (gloo only),
    the CPU when the backend is gloo and there is no card."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if shared_card:
        if backend != "gloo":
            raise ValueError("ranks that share one card need backend='gloo' "
                             "(NCCL refuses two ranks on one device)")
        if n == 0:
            raise RuntimeError("shared_card=True needs a CUDA device")
        return torch.device("cuda", 0)
    if backend == "nccl":
        if rank >= n:
            raise RuntimeError(f"rank {rank} needs cuda:{rank} but {n} card(s) are "
                               "visible; use fewer ranks or backend='gloo' with "
                               "shared_card=True")
        return torch.device("cuda", rank)
    return torch.device("cpu")


def _spawn_entry(rank: int, fn: Callable, world_size: int, backend: str, store: str,
                 device_kind: str, args: tuple, out_dir: str) -> None:
    if device_kind == "cpu":
        dev = torch.device("cpu")
    else:
        dev = rank_device(backend, rank, shared_card=device_kind == "shared")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # the ranks share the host's cores: intra-op threads that spin past a
    # rank's share slow every rank down
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    # a rank that raises exits at once; the parent then ends the others
    result = fn(rank, dev, *args)
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, backend: str = "nccl", *, device: str = "cuda",
          args: tuple = ()) -> list:
    """Run ``fn(rank, device, *args)`` in ``world_size`` fresh processes
    (the spawn start method) joined in one ``backend`` process group over a
    ``FileStore`` in a temporary directory; returns each rank's result, in
    rank order (results cross processes through ``torch.save``, so keep
    them to tensors and plain Python values).

    ``device``: ``"cuda"`` (rank r on ``cuda:r``, the default), ``"shared"``
    (every rank on ``cuda:0``, gloo only) or ``"cpu"`` (gloo).  ``fn`` must be
    importable from the child (a module-level function)."""
    import torch.multiprocessing as mp

    if device not in ("cpu", "cuda", "shared"):
        raise ValueError(f"device must be 'cpu', 'cuda' or 'shared', got {device!r}")
    with tempfile.TemporaryDirectory(prefix="repro_torch_spawn_") as tmp:
        store = os.path.join(tmp, "store")
        mp.start_processes(_spawn_entry, nprocs=world_size, start_method="spawn",
                           args=(fn, world_size, backend, store, device, args, tmp))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]
