"""The multi-device dry run (port of the reference's `dryrun_multichip`):
the full sharded plan+control step over n ranks at a real size, each
solve held against the native heap Dijkstra.

Run it on every rank of an initialized process group of n ranks
(distributed.initialize); it builds every table itself (the host builds
are deterministic) and returns the same summary on every rank; the
primary rank prints it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from mesh_navigation_torch.config import ControllerConfig, LayerConfig
from mesh_navigation_torch.control import MeshController
from mesh_navigation_torch.control.controller import initial_state
from mesh_navigation_torch.layers import LayerStack
from mesh_navigation_torch.mesh import reorder, synthetic
from mesh_navigation_torch.mesh.arrays import build_mesh, host_array
from mesh_navigation_torch.native import NativeMesh
from mesh_navigation_torch.ops import banded_gpu as bg
from mesh_navigation_torch.ops import sweeps
from mesh_navigation_torch.parallel import distributed
from mesh_navigation_torch.parallel.partition import build_partition, partitioned_field_solve
from mesh_navigation_torch.parallel.sharded import make_device_mesh
from mesh_navigation_torch.parallel.sharded_banded import (
    build_sharded_banded_plan, sharded_banded_solve,
)

COST_LIMIT = 2.0


def _say(msg: str) -> None:
    if distributed.is_primary():
        print(msg, flush=True)


def oracle_max_err(v, f, costs: np.ndarray, seeds, dist_vb: np.ndarray, what: str) -> float:
    """Each lane b of dist_vb [V, B] against the native heap Dijkstra from
    seeds[b] over edge weights dist * (1 + (c1 + c2) / 2): reachability
    equal (an AssertionError otherwise), returns the largest |error| where
    the oracle reaches."""
    nm = NativeMesh(v, f)
    try:
        edges = nm.tables()["edges"]
        edist = np.linalg.norm(v[edges[:, 1]] - v[edges[:, 0]], axis=1).astype(np.float32)
        c1, c2 = costs[edges[:, 0]], costs[edges[:, 1]]
        ew = np.where(np.isfinite(c1) & np.isfinite(c2),
                      edist + edist * (c1 + c2) * 0.5, np.inf).astype(np.float32)
        err = 0.0
        for b, s in enumerate(seeds):
            od, _ = nm.dijkstra(ew, costs, int(s), COST_LIMIT)
            ok = np.isfinite(od)
            if not np.array_equal(np.isfinite(dist_vb[:, b]), ok):
                raise AssertionError(f"{what}: reachability mismatch on lane {b}")
            if ok.any():
                err = max(err, float(np.abs(dist_vb[:, b][ok] - od[ok]).max()))
        return err
    finally:
        nm.close()


def dryrun_multichip(n: int, mesh_n: int = 320, device=None) -> dict:
    """On each of n ranks: a mesh_n x mesh_n terrain (320^2 = 102,400
    vertices), steepness + border + their max; partitioned_field_solve on
    an (n/2, 2) grid ((n, 1) for odd n) with B = 2 * n_batch lanes; one
    batched MeshController.compute_velocity cycle; the row-sharded banded
    solve (n row shards) on the terrain's banded plan; the same on a 96 x 96
    jittered irregular plan with residual edges. Each solve against the
    native heap Dijkstra: reachability equal and max |err| < 1e-3."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"dryrun_multichip({n}) runs on {n} ranks, the process group has {world}")
    dev = distributed.local_device(device)
    n_batch = 2 if n % 2 == 0 else 1
    n_mesh = n // n_batch
    grid = make_device_mesh(n_mesh, n_batch)
    row_grid = make_device_mesh(n, 1)

    v, f = synthetic.terrain_mesh(mesh_n, mesh_n, spacing=0.5, hills=1.5, roughness=0.01, seed=0)
    mesh = build_mesh(v, f, device=dev)
    stack = LayerStack.from_configs(
        (LayerConfig(name="steepness", kind="steepness"),
         LayerConfig(name="border", kind="border"),
         LayerConfig(name="combine", kind="max_combination", inputs=("steepness", "border"))),
        default_layer="combine",
    )
    state = stack.prepare(mesh)
    ctrl = MeshController(mesh, ControllerConfig(), device=dev)
    B = 2 * n_batch
    V = mesh.num_vertices
    seeds = np.random.default_rng(0).integers(0, V, size=B)

    _, combined = stack.compute(mesh, dict(state))
    ew = sweeps.compute_edge_weights(mesh, combined, 1.0)
    W = sweeps.slot_weights(mesh, ew, combined, cost_limit=COST_LIMIT)
    part = build_partition(mesh, W, n_mesh)
    _say(f"dryrun_multichip: V={V}, shards={n_mesh} (block {part.block}), "
         f"halo={'ring' if part.neighbor_only else 'all_gather'}, "
         f"ring widths R={part.exp_right.shape[1]} L={part.exp_left.shape[1]}")

    dist_p = partitioned_field_solve(part, seeds, grid, block_sweeps=8, device=dev)
    # one batched controller cycle on top of the solved fields
    vm = torch.zeros((V, 3), device=dev)
    vm[:, 0] = 1.0
    pos = torch.tensor([1.0, 1.0, 0.0], device=dev).repeat(B, 1)
    quat = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev).repeat(B, 1)
    st = initial_state(torch.zeros((B, 3), device=dev), torch.tensor([1.0, 0.0, 0.0]))
    cmds, _ = ctrl.compute_velocity(vm.expand(B, V, 3), combined, pos, quat, st)
    if not bool(torch.isfinite(cmds.linear).all()):
        raise AssertionError("dryrun_multichip: the controller gave a non-finite command")
    costs = combined.cpu().numpy()
    dist_np = dist_p.cpu().numpy()
    err_p = oracle_max_err(v, f, costs, seeds, dist_np.T, "partitioned solve")
    if not err_p < 1e-3:
        raise AssertionError(f"partitioned solve parity fail: {err_p}")
    _say(f"dryrun_multichip ok: mesh=({n_mesh}x{n_batch}), V={V}, dist shape "
         f"{tuple(dist_p.shape)}, finite {np.isfinite(dist_np).mean():.2f}, "
         f"oracle max |err| {err_p:.2e}")

    # the banded solve on n row shards of the terrain's plan
    kplan = bg.build_banded_kernel_plan(mesh, W.cpu().numpy())
    splan = build_sharded_banded_plan(kplan, n)
    dist_b, rounds_b, conv_b = sharded_banded_solve(splan, seeds, row_grid, device=dev)
    err_b = oracle_max_err(v, f, costs, seeds, dist_b.cpu().numpy(), "sharded banded solve")
    if not (conv_b and err_b < 1e-3):
        raise AssertionError(f"sharded banded parity fail: {err_b} (converged {conv_b})")
    _say(f"dryrun_multichip sharded-banded ok: {n} row shards, rounds={rounds_b}, "
         f"converged={conv_b}, oracle max |err| {err_b:.2e}")

    # the same on an irregular plan: near residuals through the G ghost
    # rows, the far tail through the all-reduced far-source table
    vi, fi = synthetic.irregular_terrain_mesh(96, 96, spacing=0.5, jitter=0.45, hills=1.0,
                                              roughness=0.01, seed=2)
    mesh_i = reorder.build_reordered_mesh(vi, fi, device=dev)
    nz = np.clip(host_array(mesh_i, "vertex_normals")[:, 2], -1.0, 1.0)
    costs_i = np.arccos(nz).astype(np.float32)
    Wi = sweeps.slot_weights_np(mesh_i, costs_i, cost_limit=COST_LIMIT, edge_cost_factor=1.0)
    kplan_i = bg.build_banded_kernel_plan(mesh_i, Wi)
    if not kplan_i.n_residual:
        raise AssertionError("the irregular mesh lost its residuals")
    splan_i = build_sharded_banded_plan(kplan_i, n)
    seeds_i = np.random.default_rng(5).integers(0, mesh_i.num_vertices, B)
    dist_i, rounds_i, conv_i = sharded_banded_solve(splan_i, seeds_i, row_grid, device=dev)
    err_i = oracle_max_err(host_array(mesh_i, "vertices"), host_array(mesh_i, "faces"), costs_i,
                           seeds_i, dist_i.cpu().numpy(), "sharded irregular solve")
    if not (conv_i and err_i < 1e-3):
        raise AssertionError(f"sharded irregular parity fail: {err_i} (converged {conv_i})")
    _say(f"dryrun_multichip sharded-IRREGULAR ok: V={mesh_i.num_vertices}, "
         f"n_res={kplan_i.n_residual} (near+far: ghost={splan_i.ghost}, "
         f"far_table={splan_i.n_far}), rounds={rounds_i}, converged={conv_i}, "
         f"oracle max |err| {err_i:.2e}")
    return {"V": V, "grid": [n_mesh, n_batch], "lanes": B, "partition_err": err_p,
            "halo": "ring" if part.neighbor_only else "all_gather",
            "banded_rounds": rounds_b, "banded_err": err_b,
            "irregular_V": mesh_i.num_vertices, "irregular_residual": kplan_i.n_residual,
            "irregular_ghost": splan_i.ghost, "irregular_n_far": splan_i.n_far,
            "irregular_rounds": rounds_i, "irregular_err": err_i}
