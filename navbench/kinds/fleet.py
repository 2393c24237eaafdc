"""The fleet kind: a closed loop of one client, the fleet manager.

Traffic: every step a batch of `lanes` start/goal pairs. Each pose is
drawn uniformly over the map's faces, at a random point of the face at
least `bary_margin` inside each edge, on the surface (a pose off the
surface is off the map for the controller); the robots all face `quat`.
The pattern of `bench.py:159-166` (uniform over the extent), with the
poses put on the terrain. The same seed gives the same draws in the same
order.

Driver: each step hands the batch to `MeshNavServer.get_path_batch`, then
`MeshController.compute_velocity_banded` gives every robot its command on
the step's field; the step ends when the card is synchronised. The window
keeps a reservoir of `sample` robots' answers, offered `per_step` random
robots of each step, for the comparison after the window.
`control="bf16"` plans with the program's own bfloat16 field storage
(`plan_batch_banded(dtype=torch.bfloat16)`): the comparison's control,
never part of a benchmark run.

Numbers (compare.py has the shared ones): cost_gap, field_gap,
reach_errors and walk_excess of the sampled robots, and

- unconverged_steps: the window's steps whose solve did not meet its
  stopping tolerance (the plan result's `converged`); 0 is exact.
- command_gap: the least max(|d linear|, |d angular|) between the
  robot's command and the reference's commands on the reference field,
  over the predecessors within `pred_slack` of the best at the corners of
  the face MeshMap's search finds the robot on (none: off the map, no
  command); inf where none agrees on whether there is a command.
"""

from __future__ import annotations

import time

import numpy as np

from navbench import compare, drivers
from navbench.reference import control as ref_control


class Traffic:
    def __init__(self, mix: dict, vertices: np.ndarray, faces: np.ndarray, seed: int):
        self.mix, self.v, self.f = mix, vertices, faces
        self.rng = np.random.default_rng([seed, 0])
        self.quat = np.asarray(mix["quat"], np.float32)

    def _poses(self, n: int):
        face = self.rng.integers(0, len(self.f), n)
        r1, r2 = self.rng.random(n), self.rng.random(n)
        s = np.sqrt(r1)
        bary = np.stack([1.0 - s, s * (1.0 - r2), s * r2], axis=1)
        m = self.mix["bary_margin"]
        bary = m + (1.0 - 3.0 * m) * bary
        tri = self.v[self.f[face]].astype(np.float64)
        pos = np.einsum("nk,nkc->nc", bary, tri).astype(np.float32)
        return pos, face, bary

    def draw(self) -> dict:
        """One step: starts, goals, quats ([B, 3], [B, 3], [B, 4] f32) and
        the faces and barycentric weights of the starts."""
        B = self.mix["lanes"]
        starts, face, bary = self._poses(B)
        goals, _, _ = self._poses(B)
        return {"starts": starts, "goals": goals, "quats": np.tile(self.quat, (B, 1)),
                "start_face": face, "start_bary": bary}


class Driver:
    def __init__(self, server, traffic: Traffic, mix: dict, device, seed: int, control=None):
        if server.banded_plan is None:
            raise RuntimeError("the fleet driver needs the server's banded plan")
        self.srv, self.gen, self.mix, self.device = server, traffic, mix, device
        self.control = control
        self.rng = np.random.default_rng([seed, 1])

    def step(self, draw: dict, timer=None):
        import torch
        from mesh_navigation_torch.control.controller import initial_state

        srv, dev = self.srv, self.device
        S = torch.from_numpy(draw["starts"]).to(dev)
        G = torch.from_numpy(draw["goals"]).to(dev)
        Q = torch.from_numpy(draw["quats"]).to(dev)
        if self.control == "bf16":
            res = srv.planner.plan_batch_banded(srv.banded_plan, S, G, dtype=torch.bfloat16,
                                                timer=timer)
        else:
            res = srv.get_path_batch(S, G, timer=timer)
        st = initial_state(G, torch.tensor([1.0, 0.0, 0.0]))
        d_flat = res.d_pad.reshape(-1, res.d_pad.shape[-1])
        cmds, _ = srv.controller.compute_velocity_banded(
            srv.banded_plan, d_flat, srv.vertex_costs, S, Q, st, lane_map=res.lane_map,
            timer=timer)
        return res, cmds

    def warm(self, n: int) -> None:
        for _ in range(n):
            self.step(self.gen.draw())
            drivers.sync(self.device)

    @staticmethod
    def _record(draw: dict, res, cmds, r: int) -> dict:
        """Robot r's inputs and answers: its lane's field column, path and
        command (copies, so the step's field is freed)."""
        import torch

        lane = int(res.lane_map[r])
        col = res.d_pad.reshape(-1, res.d_pad.shape[-1])[:, lane]
        return {"start": draw["starts"][r], "goal": draw["goals"][r],
                "col": col.to(torch.float32, copy=True),
                "path": res.path_positions[r].clone(), "valid": res.path_valid[r].clone(),
                "cmd": torch.stack([cmds.linear[r], cmds.angular[r],
                                    (cmds.outcome[r] == 0).float()])}

    def window(self, seconds: float, timer=None) -> dict:
        import torch

        keep = drivers.Reservoir(self.mix["sample"], self.rng)
        B = self.mix["lanes"]
        fails = torch.zeros((), dtype=torch.int64, device=self.device)
        rounds, unconverged, steps = [], 0, 0
        t0 = time.perf_counter()
        while True:
            draw = self.gen.draw()
            res, cmds = self.step(draw, timer)
            fails += (res.outcome != 0).sum()
            for _ in range(self.mix["per_step"]):
                r = int(self.rng.integers(B))
                j = keep.slot()
                if j is not None:
                    keep.items[j] = self._record(draw, res, cmds, r)
            rounds.append(int(res.rounds))
            unconverged += not bool(res.converged)
            shape = tuple(res.d_pad.shape)
            del res, cmds
            drivers.sync(self.device)
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        return {"steps": steps, "window_s": window_s, "attempted": steps * B,
                "failed": int(fails), "rounds": rounds, "records": keep.items,
                "answers": {"unconverged_steps": unconverged},
                "field_shape": shape, "e2e": {"solves_per_s": steps * B / window_s}}


def readings(ref: compare.Reference, answers: dict, perm: np.ndarray, mix: dict,
             config: dict) -> dict:
    """Each sampled robot's readings: {number: [reading, ...]}."""
    records = answers["records"]
    graph = ref.graph(ref.stack())
    goals = ref.mesh.nearest_vertex(np.stack([r["goal"] for r in records]))
    starts = ref.mesh.nearest_vertex(np.stack([r["start"] for r in records]))
    fields = graph.fields(goals)
    atol, rtol = mix["field_tol"]
    heading = np.array([1.0, 0.0, 0.0])
    out = {"field_gap": [], "reach_errors": [], "walk_excess": [], "command_gap": []}
    for rec, dist, s, g in zip(records, fields, starts, goals):
        col = compare.unpad(rec["col"], perm, *answers["plan_cols"])
        gap, miss = compare.field_gap(col, dist, atol, rtol)
        out["field_gap"].append(gap)
        out["reach_errors"].append(miss)
        out["walk_excess"].append(compare.walk_excess(ref.mesh, graph, dist, rec, int(s),
                                                      int(g)))
        cmd = (float(rec["cmd"][0]), float(rec["cmd"][1]), bool(rec["cmd"][2] > 0.5))
        out["command_gap"].append(ref_control.command_gap(
            graph, dist, rec["start"], heading, cmd, config["controller"],
            mix["pred_slack"]))
    return out


def numbers(ref: compare.Reference, answers: dict, mix: dict, config: dict) -> dict:
    perm = compare.program_order(ref.mesh, answers["vertices"])
    prog = np.empty(ref.mesh.V, np.float32)
    prog[perm] = answers["costs"]
    out = {"unconverged_steps": answers["unconverged_steps"],
           "cost_gap": compare.cost_gap(prog, ref.stack())}
    for k, vals in readings(ref, answers, perm, mix, config).items():
        out[k] = sum(vals) if k == "reach_errors" else max(vals)
    return out


def control_readings(ref: compare.Reference) -> dict:
    """The control's readings that need no run of the program: the
    reference in bfloat16 in the program's place, for the costs."""
    return {"cost_gap": compare.cost_gap(ref.stack(bf16=True), ref.stack())}
