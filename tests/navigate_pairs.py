"""navigate on chip_smoke.py's seeded pairs, the port against the
reference's loop, on the CPU.

Each pair (chip_smoke.navigation_pair on the terrain of chip_smoke.py,
seed SEED + k for k in chip_smoke.NAV_PAIRS, 25 m apart by default) is
solved on a window of the terrain around it (30 vertices of margin).
Three runs per pair and kind, all with the reference's defaults but
max_cycles (3,000):

- ``port``: the port's MeshNavServer.navigate, which puts the robot back
  on the surface after each step;
- ``reference_projected``: the reference's navigate loop
  (mesh_navigation_tpu/api/server.py:348-428) over the reference's own
  GetPath, ExePath, goal check and recovery, with the same surface
  projection after each step (the reference's tracking.locate);
- ``reference``: the reference's navigate as it is (its robot keeps its
  height). With --flat, every vertex's height is 0 and the reference runs
  as it is only.

Prints one JSON object a run and a summary line of success rates. Run:

    python tests/navigate_pairs.py [--flat]
    python tests/navigate_pairs.py --mesh-n 64 --dist 10   # the rehearsal's pairs
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax                                                                  # noqa: E402
import jax.numpy as jnp                                                     # noqa: E402
import torch                                                                # noqa: E402

import chip_smoke                                                           # noqa: E402
from mesh_navigation_tpu.api.outcomes import Outcome as JOutcome           # noqa: E402
from mesh_navigation_tpu.api.server import MeshNavServer as JMeshNavServer  # noqa: E402
from mesh_navigation_tpu.config import LayerConfig as JLayerConfig          # noqa: E402
from mesh_navigation_tpu.config import MeshMapConfig as JMeshMapConfig      # noqa: E402
from mesh_navigation_tpu.config import NavConfig as JNavConfig              # noqa: E402
from mesh_navigation_tpu.config import PlannerConfig as JPlannerConfig      # noqa: E402
from mesh_navigation_tpu.control import tracking as jtracking               # noqa: E402
from mesh_navigation_tpu.control.controller import _quat_mul               # noqa: E402
from mesh_navigation_tpu.mesh import geometry as jgeometry                  # noqa: E402
from mesh_navigation_torch.api.server import MeshNavServer                  # noqa: E402
from mesh_navigation_torch.mesh import synthetic                            # noqa: E402
from mesh_navigation_torch.mesh.arrays import build_mesh                    # noqa: E402

from test_torch_reference import reference_build_mesh                       # noqa: E402

QUAT = np.asarray([0.0, 0.0, 0.0, 1.0], np.float32)


def reference_config():
    """chip_smoke.replan_config() in the reference's classes."""
    return JNavConfig(
        mesh_map=JMeshMapConfig(default_layer="combine", edge_cost_factor=1.0),
        planner=JPlannerConfig(cost_limit=2.0),
        layers=(
            JLayerConfig(name="steep", kind="steepness", params=(("threshold", 2.0),)),
            JLayerConfig(name="obst", kind="obstacle"),
            JLayerConfig(name="infl", kind="inflation", inputs=("obst",),
                         params=(("repulsive_field", 0.0),)),
            JLayerConfig(name="combine", kind="max_combination",
                         inputs=("steep", "obst", "infl")),
        ),
    )


def terrain(n: int = chip_smoke.MESH_N, flat: bool = False):
    """The vertices of chip_smoke.py's n x n terrain (heights 0 with flat)."""
    v, _ = synthetic.terrain_mesh(n, n, spacing=0.5, hills=2.0, roughness=0.01, seed=0)
    if flat:
        v = v.copy()
        v[:, 2] = 0.0
    return v


def window(v, start, goal, n: int, margin: int = 30):
    """The grid window of the n x n terrain around a pair, within the
    terrain: (vertices, faces)."""
    lo = np.maximum(np.floor(np.minimum(start, goal)[:2] / 0.5).astype(int) - margin, 0)
    hi = np.minimum(np.ceil(np.maximum(start, goal)[:2] / 0.5).astype(int) + margin, n)
    ii, jj = np.meshgrid(np.arange(lo[0], hi[0]), np.arange(lo[1], hi[1]), indexing="ij")
    _, f = synthetic.grid_mesh(*ii.shape)
    return v[(ii * n + jj).ravel()], f


@functools.partial(jax.jit, static_argnums=(7,))
def _step_projected(mesh, grid, position, orientation, linear, angular, face, dt):
    """The reference's unicycle step (server.py:404-412), then the
    position put on the tracked face as the port's navigate does."""
    fwd = jgeometry.direction_from_pose(orientation)
    up = jgeometry.direction_from_pose(orientation,
                                       jnp.asarray([0.0, 0.0, 1.0], orientation.dtype))
    position = position + fwd * linear * dt
    half = angular * dt * 0.5
    dq = jnp.concatenate([up * jnp.sin(half), jnp.cos(half)[None]])
    orientation = jgeometry.normalize(_quat_mul(dq, orientation))
    fix = jtracking.locate(mesh, grid, position, face, max_dist=0.4)
    return jnp.where(fix.found, fix.position, position), orientation


def reference_navigate_projected(srv, position, orientation, goal, *, dist_tolerance=0.3,
                                 angle_tolerance=3.2, max_cycles=2048, replan_every=256,
                                 max_recoveries=2, dt=0.05) -> dict:
    """The reference's navigate loop (server.py:348-428) with the surface
    projection after each step."""
    def result(outcome, cycles, recoveries):
        return {"outcome": JOutcome(int(outcome)), "cycles": cycles, "recoveries": recoveries,
                "final_position": position}

    recoveries = 0
    plan = srv.get_path(position, goal)
    if int(plan.outcome) != JOutcome.SUCCESS:
        return result(plan.outcome, 0, 0)
    state = srv.set_plan(plan)
    cycles = 0
    while cycles < max_cycles:
        if bool(srv.is_goal_reached(position, orientation, state, dist_tolerance,
                                    angle_tolerance)):
            return result(JOutcome.SUCCESS, cycles, recoveries)
        cmd, state = srv.exe_path_step(plan, position, orientation, state)
        if int(cmd.outcome) != JOutcome.SUCCESS:
            if recoveries >= max_recoveries:
                return result(cmd.outcome, cycles, recoveries)
            recoveries += 1
            srv.recovery("clear")
            plan = srv.get_path(position, goal)
            if int(plan.outcome) != JOutcome.SUCCESS:
                return result(plan.outcome, cycles, recoveries)
            state = srv.set_plan(plan)
            continue
        position, orientation = _step_projected(srv.mesh, srv.grid, position, orientation,
                                                cmd.linear, cmd.angular, state.current_face, dt)
        cycles += 1
        if replan_every and cycles % replan_every == 0:
            plan = srv.get_path(position, goal)
            if int(plan.outcome) == JOutcome.SUCCESS:
                state = srv.set_plan(plan)._replace(current_face=state.current_face)
    return result(JOutcome.PAT_EXCEEDED, cycles, recoveries)


def run_pair(v, n: int, k: int, kind: str, *, dist: float = 25.0, flat: bool = False,
             max_cycles: int = 3000,
             runs=("port", "reference_projected", "reference")) -> list[dict]:
    """The runs of one pair (seed SEED + k, dist metres apart) and kind on
    its window of the n x n terrain."""
    start, goal = chip_smoke.navigation_pair(v, n, np.random.default_rng(chip_smoke.SEED + k),
                                             dist)
    wv, wf = window(v, start, goal, n)
    out = []
    for run in runs:
        if flat and run == "reference_projected":
            continue
        t0 = time.perf_counter()
        if run == "port":
            srv = MeshNavServer(build_mesh(wv, wf, device="cpu"), chip_smoke.replan_config(),
                                planner_kind=kind, max_path_len=2048, device="cpu")
            r = srv.navigate(torch.from_numpy(start), torch.from_numpy(QUAT),
                             torch.from_numpy(goal), max_cycles=max_cycles)
            final = r["final_position"].numpy()
        else:
            srv = JMeshNavServer(reference_build_mesh(wv, wf), reference_config(),
                                 planner_kind=kind, max_path_len=2048)
            args = (jnp.asarray(start), jnp.asarray(QUAT), jnp.asarray(goal))
            if run == "reference":
                r = srv.navigate(*args, max_cycles=max_cycles)
            else:
                r = reference_navigate_projected(srv, *args, max_cycles=max_cycles)
            final = np.asarray(r["final_position"])
        out.append({"pair": k, "kind": kind, "run": run, "mesh_n": n, "dist": dist,
                    "flat": flat,
                    "start": start.tolist(), "goal": goal.tolist(),
                    "outcome": r["outcome"].name, "cycles": int(r["cycles"]),
                    "recoveries": int(r["recoveries"]), "final": final.tolist(),
                    "final_to_goal_m": float(np.linalg.norm(final - goal)),
                    "wall_s": time.perf_counter() - t0})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh-n", type=int, default=chip_smoke.MESH_N)
    ap.add_argument("--dist", type=float, default=25.0, help="start-goal metres")
    ap.add_argument("--flat", action="store_true", help="every vertex at height 0")
    args = ap.parse_args()
    torch.set_num_threads(4)
    v = terrain(args.mesh_n, args.flat)
    rows = []
    for k in chip_smoke.NAV_PAIRS:
        for kind in ("dijkstra", "cvp"):
            for row in run_pair(v, args.mesh_n, k, kind, dist=args.dist, flat=args.flat):
                print(json.dumps(row), flush=True)
                rows.append(row)
    rates = {}
    for row in rows:
        key = f"{row['kind']}/{row['run']}"
        n, s = rates.get(key, (0, 0))
        rates[key] = (n + 1, s + (row["outcome"] == "SUCCESS"))
    print(json.dumps({"success_rate": {k: f"{s}/{n}" for k, (n, s) in rates.items()},
                      "mesh_n": args.mesh_n, "dist": args.dist, "flat": args.flat}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
