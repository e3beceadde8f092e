"""Device mesh over torch.distributed ranks.

The reference organizes ranks as an nprow x npcol MPI process grid
(src/solve_ABglobal.c:307 superlu_gridinit). The port of the JAX
package's ``parallel/mesh.py``: a named layout of ``torch.distributed``
ranks, one rank per device. The solver shards front batches over the
leading axis ("front") and the stencil SpMV shards the latitude axis over
it ("band", the 1-D block-row domain decomposition, the analog of
solve_ABdist.c:139-144). An optional second axis "rhs" adds data
parallelism over right-hand sides; each row of the mesh along it (the
ranks that share a primary coordinate) gets a process group of its own,
and so does each column (the ranks that share an "rhs" coordinate, which
shard the factors between them).

The mesh lives on the default process group, which the caller starts, for
instance with ``init_process_group`` below (NCCL for CUDA tensors and gloo
for CPU tensors unless the caller names the backend), or ``run_world``,
which starts the ranks themselves for the entry points that take a rank
count: nothing here starts one behind the caller's back. A single process
with no group is a world of one.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """A row-major layout of the global ranks ``ranks`` over ``shape``,
    named by ``axis_names``: (primary,) or (primary, "rhs"). ``coords`` is
    this rank's position, None when the rank is outside the mesh;
    ``group`` the process group of the mesh's ranks (None: the default
    group, or no group in a world of one); ``rhs_groups`` one group per
    row along "rhs" (empty without that axis); ``front_groups`` one group
    per column along the primary axis with an "rhs" axis (empty without
    it: the column is then the mesh itself)."""
    axis_names: tuple
    shape: tuple
    ranks: tuple
    coords: tuple | None
    group: object = None
    rhs_groups: tuple = ()
    front_groups: tuple = ()

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def front_group(self):
        """The group of the ranks that share this rank's "rhs" coordinate:
        the ones that shard the factors between them along the primary
        axis (``group`` without an "rhs" axis; None outside the mesh)."""
        if self.coords is None:
            return None
        if not self.front_groups:
            return self.group
        return self.front_groups[self.coords[1]]

    @property
    def rhs_group(self):
        """This rank's group along "rhs" (None without that axis or
        outside the mesh)."""
        if not self.rhs_groups or self.coords is None:
            return None
        return self.rhs_groups[self.coords[0]]


def _world() -> tuple[int, int]:
    """(world size, rank) of the default group; (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(n_devices: int | None = None, axis_names=("band",),
              rhs_devices: int = 1) -> Mesh:
    """Build a 1-D mesh over axis_names[0] on the first ``n_devices`` ranks
    (all of them by default), or a 2-D (axis, "rhs") mesh when
    rhs_devices > 1 (which must divide n_devices). Collective: every rank
    of the default group calls it with the same arguments, since it makes
    the groups of a mesh smaller than the world and of the "rhs" rows."""
    world, rank = _world()
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(f"requested {n_devices} devices, have {world}")
    if len(axis_names) != 1:
        raise ValueError("pass a single primary axis name (front/band); "
                         "rhs parallelism is requested via rhs_devices")
    if rhs_devices > 1:
        if n_devices % rhs_devices:
            raise ValueError(f"rhs_devices={rhs_devices} must divide "
                             f"n_devices={n_devices}")
        shape = (n_devices // rhs_devices, rhs_devices)
        names = (axis_names[0], "rhs")
    else:
        shape = (n_devices,)
        names = tuple(axis_names)
    ranks = tuple(range(n_devices))
    group = None
    if n_devices < world:
        group = dist.new_group(ranks=list(ranks))
    rhs_groups = front_groups = ()
    if rhs_devices > 1:
        rhs_groups = tuple(
            dist.new_group(ranks=[r * rhs_devices + c
                                  for c in range(rhs_devices)])
            for r in range(shape[0]))
        front_groups = tuple(
            dist.new_group(ranks=[r * rhs_devices + c
                                  for r in range(shape[0])])
            for c in range(rhs_devices))
    coords = None
    if rank < n_devices:
        coords = ((rank // rhs_devices, rank % rhs_devices)
                  if rhs_devices > 1 else (rank,))
    return Mesh(axis_names=names, shape=shape, ranks=ranks, coords=coords,
                group=group, rhs_groups=rhs_groups,
                front_groups=front_groups)


def init_process_group(device: str | torch.device, rank: int,
                       world_size: int, store_path: str,
                       backend: str | None = None) -> torch.device:
    """Start the default process group of ``world_size`` ranks as
    ``rank``, meeting through the file ``store_path`` (one that does not
    exist yet, on a file system all ranks see). ``backend`` defaults to
    NCCL when ``device`` is cuda (this rank's card is rank mod the card
    count, made current) and to gloo when it is cpu; ``backend="gloo"``
    with cuda gives a world whose ranks may share a card, each collective
    then going through the host (parallel.collectives). Returns this
    rank's torch.device."""
    dev = torch.device(device)
    if dev.type == "cuda":
        index = dev.index
        if index is None:
            if not torch.cuda.is_available():
                raise RuntimeError("init_process_group: cuda requested but "
                                   "no CUDA device is available")
            index = rank % torch.cuda.device_count()
        dev = resolve_device(f"cuda:{index}")
        torch.cuda.set_device(dev)
        backend = backend or "nccl"
    elif dev.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on the CPU: only gloo "
                             f"runs CPU tensors")
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {device!r} (expected cuda or "
                         f"cpu)")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported backend {backend!r} (expected nccl "
                         f"or gloo)")
    dist.init_process_group(
        backend, init_method=f"file://{os.path.abspath(store_path)}",
        rank=rank, world_size=world_size)
    return dev


def _rank_main(rank: int, world: int, store: str, device: str,
               backend: str | None, target, args: tuple) -> None:
    """One rank of ``run_world``: its process group, then target."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dev = init_process_group(device, rank, world, store, backend=backend)
    try:
        target(dev, *args)
    finally:
        dist.destroy_process_group()


def check_world(n_ranks: int, device: str | torch.device,
                backend: str | None = None) -> torch.device:
    """The device type ``run_world`` starts ``n_ranks`` ranks on, checked
    before any rank starts: cuda needs a card per rank unless
    ``backend="gloo"`` lets ranks share them (ValueError "requested N
    devices, have M" otherwise); only cuda and cpu are supported."""
    dev = torch.device(device)
    if dev.type == "cuda" and backend != "gloo":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_ranks > have:
            raise ValueError(f"requested {n_ranks} devices, have {have}")
    elif dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (expected cuda or "
                         f"cpu)")
    return dev


def run_world(target, n_ranks: int, device: str | torch.device, *args,
              backend: str | None = None) -> None:
    """``target(this rank's torch.device, *args)`` on ``n_ranks`` ranks
    started here (torch.multiprocessing spawn; ``target`` and ``args`` must
    pickle), each in a default process group of ``n_ranks`` ranks that
    meet through a file store in a temporary directory: gloo on cpu; on
    cuda NCCL with one card per rank (ValueError "requested N devices,
    have M" when there are fewer cards, ``check_world``), or, with
    ``backend="gloo"``, ranks that share the cards there are. A rank that
    fails stops the others, and the failure is raised here."""
    dev = check_world(n_ranks, device, backend)
    with tempfile.TemporaryDirectory(prefix="nk_ranks_") as tmp:
        torch.multiprocessing.start_processes(
            _rank_main, args=(n_ranks, os.path.join(tmp, "store"), dev.type,
                              backend, target, args),
            nprocs=n_ranks, join=True, start_method="spawn")
