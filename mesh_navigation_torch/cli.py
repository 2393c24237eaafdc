"""CLI entry (port of mesh_navigation_tpu/cli.py), the `mbf_mesh_nav` binary
analog.

Loads a mesh (OBJ/PLY/OFF/STL/DAE/H5, or a synthetic terrain), configures
the layer DAG, plans one path with the selected planner, optionally runs a
closed-loop controller rollout, and exports visualization artifacts. Runs
on the card unless `--device cpu` asks for the CPU.

    python -m mesh_navigation_torch --mesh map.ply \\
        --start 1 1 0 --goal 20 20 0 --planner cvp \\
        --layers steepness,border --out /tmp/nav

Prints one JSON line (outcome, cost, path_points, plan_time_s, and
rollout_final_dist_to_goal / exports where asked); exits 0 on SUCCESS,
else 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def build_layer_configs(names: list[str]):
    from mesh_navigation_torch.config import LayerConfig

    cfgs = [LayerConfig(name=n, kind=n) for n in names]
    if len(cfgs) > 1:
        cfgs.append(
            LayerConfig(
                name="combined", kind="max_combination",
                inputs=tuple(c.name for c in cfgs),
            )
        )
    return tuple(cfgs)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="mesh_navigation_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mesh", help="mesh file (.obj/.ply/.off/.stl/.dae/.h5); omit for synthetic terrain")
    ap.add_argument("--working-file", help="HDF5 working file (cached bundle)")
    ap.add_argument("--synthetic", type=int, default=64, help="synthetic terrain side (vertices)")
    ap.add_argument("--start", nargs=3, type=float, required=True)
    ap.add_argument("--goal", nargs=3, type=float, required=True)
    ap.add_argument("--planner", choices=["dijkstra", "cvp"], default="cvp")
    ap.add_argument("--layers", default="steepness",
                    help="comma list: height_diff,roughness,steepness,ridge,border,clearance")
    ap.add_argument("--edge-cost-factor", type=float, default=1.0)
    ap.add_argument("--cost-limit", type=float, default=2.0)
    ap.add_argument("--rollout", type=int, default=0, help="controller rollout steps")
    ap.add_argument("--out", default="", help="output dir for PLY/OBJ exports")
    ap.add_argument("--snap", action=argparse.BooleanOptionalAction, default=True,
                    help="snap start/goal z onto the surface")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    import torch

    from mesh_navigation_torch.api.outcomes import Outcome
    from mesh_navigation_torch.api.server import MeshNavServer
    from mesh_navigation_torch.config import MeshMapConfig, NavConfig, PlannerConfig
    from mesh_navigation_torch.device import resolve_device
    from mesh_navigation_torch.mesh import io, query, synthetic
    from mesh_navigation_torch.mesh.arrays import build_mesh, host_array

    device = resolve_device(args.device)
    t0 = time.time()
    if args.mesh:
        mesh = io.read_map(args.mesh, args.working_file, device=device)
    else:
        v, f = synthetic.terrain_mesh(args.synthetic, args.synthetic, spacing=0.5, hills=1.5,
                                      seed=0)
        mesh = build_mesh(v, f, device=device)
    print(f"map: {mesh.num_vertices} vertices, {mesh.num_faces} faces "
          f"({time.time()-t0:.1f}s)", file=sys.stderr)

    layer_names = [n for n in args.layers.split(",") if n]
    cfg = NavConfig(
        mesh_map=MeshMapConfig(edge_cost_factor=args.edge_cost_factor),
        planner=PlannerConfig(cost_limit=args.cost_limit),
        layers=build_layer_configs(layer_names),
    )
    srv = MeshNavServer(mesh, cfg, planner_kind=args.planner, device=device)

    start = torch.tensor(args.start, dtype=torch.float32, device=device)
    goal = torch.tensor(args.goal, dtype=torch.float32, device=device)
    if args.snap:
        # project the requested poses onto the surface (z from the nearest
        # vertex) so hilly maps accept xy-specified poses
        sv, _ = query.nearest_vertex(srv.mesh, srv.grid, start)
        gv, _ = query.nearest_vertex(srv.mesh, srv.grid, goal)
        start[2] = srv.mesh.vertices[sv, 2]
        goal[2] = srv.mesh.vertices[gv, 2]
    t1 = time.time()
    res = srv.get_path(start, goal)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t1

    out = {
        "outcome": Outcome(int(res.outcome)).name,
        "cost": float(res.cost),
        "path_points": int(res.path_valid.sum()),
        "plan_time_s": round(dt, 3),
    }

    if args.rollout and int(res.outcome) == 0:
        st = srv.set_plan(res)
        quat = torch.tensor([0.0, 0.0, 0.0, 1.0], device=device)
        traj, _, st = srv.controller.rollout(res.vector_map, srv.vertex_costs, start, quat, st,
                                             num_steps=args.rollout)
        out["rollout_final_dist_to_goal"] = float(torch.linalg.norm(traj[-1] - goal))

    if args.out:
        from mesh_navigation_torch.utils import viz

        os.makedirs(args.out, exist_ok=True)
        verts, faces = host_array(mesh, "vertices"), host_array(mesh, "faces")
        viz.write_cost_ply(os.path.join(args.out, "vertex_costs.ply"), verts, faces,
                           srv.vertex_costs.cpu().numpy())
        viz.write_cost_ply(os.path.join(args.out, "potential.ply"), verts, faces,
                           res.potential.cpu().numpy())
        viz.write_vector_field_obj(os.path.join(args.out, "vector_field.obj"), verts,
                                   res.vector_map.cpu().numpy())
        viz.write_path_obj(os.path.join(args.out, "path.obj"), res.path_positions.cpu().numpy(),
                           res.path_valid.cpu().numpy())
        out["exports"] = args.out

    print(json.dumps(out))
    return 0 if out["outcome"] == "SUCCESS" else 1


if __name__ == "__main__":
    raise SystemExit(main())
