"""Rank functions of the port's multi-process tests, and the spawner that
runs them (pytest collects nothing here).

It imports only torch and the port: a spawned rank that imported a test
module would import JAX and the reference, seconds a rank. `run` saves the
payload in a temporary directory, spawns n ranks (the `spawn` start
method), which rendezvous through a file store in the same directory (no
fixed port: test workers run at once), and returns rank 0's result. A
rank that fails fails `run`: torch.multiprocessing.spawn joins every rank
and raises on any error, after ending the others.
"""

from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mesh_navigation_torch.ops import kernels
from mesh_navigation_torch.parallel import (
    distributed, make_device_mesh, partitioned_field_solve, sharded_banded_solve,
    sharded_field_solve,
)


def run(fn_name: str, n: int, payload: dict, *, backend: str = "gloo", device="cpu"):
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(payload, os.path.join(tmp, "in.pt"))
        mp.spawn(_entry, args=(fn_name, n, tmp, backend, device), nprocs=n, join=True)
        return torch.load(os.path.join(tmp, "out.pt"), weights_only=False)


def _entry(rank: int, fn_name: str, n: int, tmp: str, backend: str, device) -> None:
    torch.set_num_threads(1)
    distributed.initialize(backend, init_method=f"file://{tmp}/store", world_size=n, rank=rank)
    try:
        payload = torch.load(os.path.join(tmp, "in.pt"), weights_only=False)
        out = globals()[fn_name](payload, device)
        if rank == 0:
            torch.save(out, os.path.join(tmp, "out.pt"))
    finally:
        dist.destroy_process_group()


def _cpu(x):
    return x.cpu() if isinstance(x, torch.Tensor) else x


def _grid_coords(n_batch: int) -> list:
    """Every rank's (rank, mesh index, batch index, mesh ranks, batch ranks,
    shape) in pod_mesh(n_batch), gathered to every rank."""
    g = distributed.pod_mesh(n_batch)
    mine = (g.rank, g.mesh_index, g.batch_index, g.mesh_ranks, g.batch_ranks, g.shape)
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, mine)
    return out


def gather_solves(payload: dict, device) -> dict:
    """sharded_field_solve and partitioned_field_solve on one grid, each
    where the payload holds its tables ("sharded", "part") and seeds."""
    grid = make_device_mesh(*payload["shape"])
    out = {"coords": _grid_coords(payload["shape"][1])}
    kw = dict(max_sweeps=payload["max_sweeps"], device=device)
    if "sharded" in payload:
        out["sharded"] = _cpu(sharded_field_solve(payload["sharded"], payload["sharded_seeds"],
                                                  grid, **kw))
    if "part" in payload:
        out["partitioned"] = _cpu(partitioned_field_solve(payload["part"], payload["part_seeds"],
                                                          grid, **kw))
    return out


def banded_solve(payload: dict, device) -> tuple:
    """sharded_banded_solve on an (n, 1) grid: (dist [V, B], rounds,
    converged, every rank's pass kernel launches)."""
    grid = make_device_mesh(payload["splan"].n_shards, 1)
    before = kernels.LAUNCHES["banded_pass"]
    d, rounds, conv = sharded_banded_solve(payload["splan"], payload["seeds"], grid,
                                           atol=payload.get("atol", 0.0),
                                           rtol=payload.get("rtol", 0.0), device=device)
    launches = [None] * dist.get_world_size()
    dist.all_gather_object(launches, kernels.LAUNCHES["banded_pass"] - before)
    return _cpu(d), rounds, conv, launches


def dryrun(payload: dict, device) -> dict:
    from mesh_navigation_torch.parallel.dryrun import dryrun_multichip

    return dryrun_multichip(dist.get_world_size(), mesh_n=payload["mesh_n"], device=device)
