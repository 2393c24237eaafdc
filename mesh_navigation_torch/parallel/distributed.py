"""Multi-process set-up on torch.distributed (port of
mesh_navigation_tpu/parallel/distributed.py:33-68).

JAX runs one controller per host over all its devices through `shard_map`.
The port runs one process per shard, as `torchrun` or
`torch.multiprocessing.spawn` start them: every rank builds the same host
plan (the host builds are deterministic), moves only its own shard to its
device, and each solve returns the global result on every rank.

Usage on each rank (for instance `torchrun --nproc-per-node 4 script.py`):

    from mesh_navigation_torch.parallel import distributed
    distributed.initialize("nccl")               # torchrun's environment
    grid = distributed.pod_mesh(n_batch=2)       # ('mesh', 'batch') over all ranks
    part = build_partition(mesh, W, grid.shape["mesh"])
    dist = partitioned_field_solve(part, seeds, grid)

The ranks of a grid are laid out batch-major: rank = batch * n_mesh + mesh,
so consecutive ranks hold consecutive shards and the halo exchange stays
between neighbouring ranks (neighbouring cards of one host under torchrun).
How tensors travel under each backend is parallel/comm.py's rule.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from mesh_navigation_torch.device import resolve_device

# how long a rank waits in a collective for the others before it fails
TIMEOUT = datetime.timedelta(minutes=10)


def initialize(
    backend: str = "nccl",
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
) -> bool:
    """Join the process group. With one process and no rendezvous in the
    environment (MASTER_ADDR) or the arguments it does nothing and returns
    False, as the reference does. Arguments default to torchrun's
    environment (WORLD_SIZE, RANK; LOCAL_RANK and LOCAL_WORLD_SIZE place
    the ranks of one host on its cards). The backend is the caller's
    choice: NCCL with more ranks on this host than cards raises, it never
    switches to gloo. Returns True once the group is up."""
    if dist.is_initialized():
        return True
    env = os.environ
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", 1))
    if world_size == 1 and init_method is None and not env.get("MASTER_ADDR"):
        return False
    if rank is None:
        rank = int(env.get("RANK", 0))
    if backend == "nccl":
        local_ranks = int(env.get("LOCAL_WORLD_SIZE", world_size))
        cards = torch.cuda.device_count()
        if local_ranks > cards:
            raise RuntimeError(
                f"NCCL needs a card for each rank: {local_ranks} ranks on this host, "
                f"{cards} cards (gloo shares a card, if the caller asks for it)"
            )
        torch.cuda.set_device(local_rank(rank))
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size, rank=rank,
        timeout=TIMEOUT,
    )
    return True


def local_rank(rank: int | None = None) -> int:
    """This process's rank among the ranks of its host: LOCAL_RANK where
    torchrun set it, else the global rank (processes spawned on one host)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if rank is not None:
        return rank
    return dist.get_rank() if dist.is_initialized() else 0


def local_device(device=None) -> torch.device:
    """The device a rank's shard lives on: `device` where given, else
    cuda:{local_rank % device_count} (an error where there is no card)."""
    if device is not None:
        return resolve_device(device)
    resolve_device("cuda")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


@dataclasses.dataclass(frozen=True)
class DeviceGrid:
    """A ('mesh', 'batch') grid of ranks, as this rank sees it: the grid's
    shape, this rank's coordinates, the global ranks along its mesh axis
    (shard order) and its batch axis, and the process group of each axis
    (None where the axis spans every rank or one rank, whose collectives
    go to the world group or are the identity)."""
    shape: dict
    rank: int
    mesh_index: int
    batch_index: int
    mesh_ranks: tuple
    batch_ranks: tuple
    mesh_group: object = None
    batch_group: object = None


def make_grid(n_mesh: int, n_batch: int) -> DeviceGrid:
    """The grid over all ranks of the process group (one rank without one).
    Every rank must call it, in the same order as its other groups: each
    group is made by all ranks."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_mesh * n_batch != world:
        raise ValueError(f"a ({n_mesh}, {n_batch}) grid needs {n_mesh * n_batch} ranks, "
                         f"the process group has {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    b, m = divmod(rank, n_mesh)
    columns = [tuple(bb * n_mesh + mm for mm in range(n_mesh)) for bb in range(n_batch)]
    rows = [tuple(bb * n_mesh + mm for bb in range(n_batch)) for mm in range(n_mesh)]
    mesh_group = batch_group = None
    if n_mesh > 1 and n_batch > 1:
        # an axis of one rank needs no group and an axis of every rank is
        # the world; new_group is collective over the whole world, so every
        # rank makes every group, in one order
        mesh_group = [dist.new_group(list(c)) for c in columns][b]
        batch_group = [dist.new_group(list(r)) for r in rows][m]
    return DeviceGrid(shape={"mesh": n_mesh, "batch": n_batch}, rank=rank, mesh_index=m,
                      batch_index=b, mesh_ranks=columns[b], batch_ranks=rows[m],
                      mesh_group=mesh_group, batch_group=batch_group)


def pod_mesh(n_batch: int = 1) -> DeviceGrid:
    """The global ('mesh', 'batch') grid over every rank."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % n_batch != 0:
        raise ValueError(f"{world} ranks not divisible by n_batch={n_batch}")
    return make_grid(world // n_batch, n_batch)
