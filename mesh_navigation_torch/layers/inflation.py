"""Geodesic inflation layer: wavefront distance from lethal seeds, cost
fading and the repulsive vector field (port of
mesh_navigation_tpu/layers/inflation.py).

Parity with mesh_layers/src/inflation_layer.cpp: every input-layer lethal
vertex seeds the wave at distance 0, a Sethian wavefront bounded by the
inflation radius gives the distance (341-491), the costmap_2d-style decay
turns it into cost (315-339), and unit vectors pointing away from the
obstacles accumulate along the wave (277-308) for `meshAhead` and the
controller to blend into the planner's field (493-561). The wave runs as the
shift-based banded Sethian solve (ops/banded_sethian.py) where the mesh has
band structure, else as the gather eikonal solve with the same Sethian
update (ops/eikonal.py). The order-dependent vector accumulation becomes one
seed-face pass and a fixed-point propagation along the winning updates.

A state that holds SKIP_VECTORS (the live-replan step, which reads only
costs) gets zero vectors: the costs are the same bit for bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mesh_navigation_torch.config import LayerConfig
from mesh_navigation_torch.layers.base import (
    SKIP_VECTORS, LayerOutput, register_layer, zero_vectors,
)
from mesh_navigation_torch.mesh import geometry
from mesh_navigation_torch.mesh.arrays import MeshArrays
from mesh_navigation_torch.ops import banded_sethian as _bs
from mesh_navigation_torch.ops import eikonal

INF = float("inf")


class InflationParams(NamedTuple):
    """inflation_layer.h:240-248 defaults."""
    inscribed_radius: float = 0.25
    inflation_radius: float = 0.4
    lethal_value: float = 1.0
    inscribed_value: float = 0.99
    cost_scaling_factor: float = 1.0
    repulsive_field: bool = True


def fading(distance: torch.Tensor, p: InflationParams) -> torch.Tensor:
    """Distance -> cost decay, the piecewise contract of
    InflationLayer::fading (inflation_layer.cpp:315-339)."""
    decay = p.inscribed_value * torch.exp(
        -p.cost_scaling_factor * (distance - p.inscribed_radius)
    )
    return torch.where(
        distance > p.inflation_radius,
        0.0,
        torch.where(
            distance > p.inscribed_radius,
            decay,
            torch.where(distance > 0.0, p.inscribed_value, p.lethal_value),
        ),
    ).to(torch.float32)


def inflation_distances(
    mesh: MeshArrays, lethal: torch.Tensor, p: InflationParams,
    *, sethian_plan: _bs.SethianPlan | None = None, window=None,
) -> torch.Tensor:
    """Geodesic distance [V] from the lethal set over raw edge distances
    (inflation_layer.cpp:452), capped at the inflation radius. With a
    `sethian_plan` (band-ordered meshes) the banded Sethian solve, which
    `window` runs on a sub-plane around the lethal set (certified exact,
    with a full-plane fallback); else the gather eikonal solve with the
    Sethian update."""
    seed = torch.where(lethal, 0.0, INF).to(torch.float32)
    if sethian_plan is not None:
        return _bs.sethian_distances_banded(
            sethian_plan, seed, source_cap=p.inflation_radius, window=window,
        )
    return eikonal.eikonal_field(
        mesh, mesh.edge_dist, seed, update="sethian", source_cap=p.inflation_radius,
    ).dist


def _normalize(a: torch.Tensor) -> torch.Tensor:
    """geometry.normalize with the squares added in a fixed order."""
    n2 = geometry.dot3(a, a)
    return a / torch.clamp(torch.sqrt(torch.clamp(n2, min=0.0)), min=1e-12)[..., None]


class RepulsiveField(NamedTuple):
    vectors: torch.Tensor   # [V, 3] f32 unit vectors away from the lethal set (0: none)
    sweeps: int             # propagation sweeps run, the first included


def repulsive_field(mesh: MeshArrays, dist: torch.Tensor, *,
                    max_sweeps: int = 64) -> RepulsiveField:
    """Unit repulsive vectors pointing away from the lethal set
    (inflation.py:103-190), the accumulation inside
    InflationLayer::waveFrontUpdate (inflation_layer.cpp:277-308):
    - faces with two seed corners (u1 == u2 == 0, u3 > 0) push
      normalize((v3 - v2) + (v3 - v1)) onto all three corners;
    - every other reached vertex takes normalize(vec[v1]·(u3 - u1) +
      vec[v2]·(u3 - u2)) through its winning face, the incident face whose
      parents are closest (smallest u1 + u2; on a tie the first incident
      slot), propagated to a fixed point: sweeps stop when no component
      moves by more than 1e-6, after at most 1 + max_sweeps.

    The pull onto the corners is a gather over the [V, FD] incident faces,
    added slot after slot in the reference's role order (no scatter-add,
    whose order is not fixed on the card): the seed tests `== 0` and the
    parent tests `!= 0` sit on exact values. Only the winning face's
    candidate is formed, not the [F, 3, 3] table of every face's."""
    V = mesh.num_vertices
    v1t, v2t, v3t, *_ = eikonal._face_corner_tables(mesh)
    pos = mesh.vertices
    u1, u2, u3 = dist[v1t], dist[v2t], dist[v3t]          # [F, 3]

    # seed contributions
    seed_face = (u1 == 0.0) & (u2 == 0.0) & (u3 > 0.0)
    d31 = pos[v3t] - pos[v1t]
    d32 = pos[v3t] - pos[v2t]
    contrib = torch.where(seed_face[..., None], _normalize(d31 + d32), 0.0)   # [F, 3, 3]
    vf = mesh.vertex_faces.long()
    vc = mesh.vertex_face_corner.long()
    vfm = mesh.vertex_faces_mask
    # vertex v at corner c of face f is v3 of corner c, v1 of corner c - 1
    # and v2 of corner c - 2
    roles = [torch.remainder(vc - shift, 3) for shift in (0, 1, 2)]
    pulled = torch.zeros((V, 3), dtype=torch.float32, device=mesh.device)
    touched = torch.zeros(V, dtype=torch.bool, device=mesh.device)
    for k in roles:
        g = torch.where(vfm[..., None], contrib[vf, k], 0.0)            # [V, FD, 3]
        part = g[:, 0]
        for j in range(1, g.shape[1]):
            part = part + g[:, j]
        pulled = pulled + part
        touched = touched | (seed_face[vf, k] & vfm).any(dim=1)
    vec = torch.where(touched[:, None], _normalize(pulled), 0.0)

    # winning-face propagation
    w31, w32 = u3 - u1, u3 - u2
    cand = (torch.isfinite(u1) & torch.isfinite(u2) & torch.isfinite(u3) & (u3 > 0.0)
            & ~seed_face & ((u1 != 0.0) | (u2 != 0.0)))
    score_all = u1 + u2
    slot = torch.arange(vf.shape[1], device=mesh.device)

    def sweep(vec):
        nonzero = torch.any(vec != 0.0, dim=-1)                         # [V]
        score = torch.where(cand & (nonzero[v1t] | nonzero[v2t]), score_all, INF)
        score_v = torch.where(vfm, score[vf, vc], INF)                  # [V, FD]
        low = score_v.amin(dim=1)
        best = torch.where(score_v == low[:, None], slot, vf.shape[1]).amin(dim=1)
        best = torch.clamp(best, max=vf.shape[1] - 1)
        wf = torch.gather(vf, 1, best[:, None])[:, 0]
        wc = torch.gather(vc, 1, best[:, None])[:, 0]
        new = _normalize(vec[v1t[wf, wc]] * w31[wf, wc, None]
                         + vec[v2t[wf, wc]] * w32[wf, wc, None])
        ok = torch.isfinite(low) & ~touched
        return torch.where(ok[:, None], new, vec)

    prev, vec, it = vec, sweep(vec), 0
    while it < max_sweeps and bool(torch.any(torch.abs(vec - prev) > 1e-6)):
        prev, vec, it = vec, sweep(vec), it + 1
    return RepulsiveField(vectors=vec, sweeps=it + 1)


def repulsive_vector_at(
    dist: torch.Tensor,
    vecmap: torch.Tensor,
    face_vertex_ids: torch.Tensor,   # [..., 3]
    bary: torch.Tensor,              # [..., 3]
    p: InflationParams,
) -> torch.Tensor:
    """Barycentric repulsive-vector lookup with the cosine fade
    (inflation.py:193-222; InflationLayer::vectorAt,
    inflation_layer.cpp:493-531), including the reference's sqrt(distance)
    in the fade argument, kept as it is."""
    if not p.repulsive_field:
        return torch.zeros(bary.shape[:-1] + (3,), dtype=torch.float32, device=bary.device)
    ids = face_vertex_ids.long()
    d = geometry.bary_interpolate(dist[ids], bary)
    vec = geometry.bary_interpolate(vecmap[ids], bary)
    alpha = ((torch.sqrt(torch.clamp(d, min=0.0)) - p.inscribed_radius)
             / (p.inflation_radius - p.inscribed_radius) * math.pi)
    fade = p.inscribed_value * (torch.cos(alpha) + 1.0) / 2.0
    scale = torch.where(
        d > p.inflation_radius,
        0.0,
        torch.where(
            d > p.inscribed_radius,
            fade,
            torch.where(d > 0.0, p.inscribed_value, p.lethal_value),
        ),
    )
    return vec * scale[..., None]


def params_from_config(cfg: LayerConfig) -> InflationParams:
    return InflationParams(
        inscribed_radius=cfg.param("inscribed_radius", 0.25),
        inflation_radius=cfg.param("inflation_radius", 0.4),
        lethal_value=cfg.param("lethal_value", 1.0),
        inscribed_value=cfg.param("inscribed_value", 0.99),
        cost_scaling_factor=cfg.param("cost_scaling_factor", 1.0),
        repulsive_field=bool(cfg.param("repulsive_field", 1.0)),
    )


@register_layer("inflation")
def make_inflation(cfg: LayerConfig):
    p = params_from_config(cfg)

    def fn(mesh: MeshArrays, inputs: dict, state) -> LayerOutput:
        if inputs:
            lethal = torch.stack([o.lethal for o in inputs.values()]).any(dim=0)
        else:
            lethal = torch.zeros(mesh.num_vertices, dtype=torch.bool, device=mesh.device)
        dist = inflation_distances(
            mesh, lethal, p, sethian_plan=state.get("__sethian_plan__"),
            window=state.get("__inflation_window__"),
        )
        costs = torch.where(torch.isfinite(dist), fading(dist, p), 0.0)
        if p.repulsive_field and not state.get(SKIP_VECTORS):
            vectors = repulsive_field(mesh, dist).vectors
        else:
            vectors = zero_vectors(mesh)
        # distances and vectors for vectorAt-style lookups
        state[f"inflation:{cfg.name}"] = (dist, vectors)
        return LayerOutput(costs=costs, lethal=lethal, vectors=vectors)

    def prepare(m: MeshArrays) -> dict:
        try:
            return {"__sethian_plan__": _bs.build_sethian_plan(m)}
        except ValueError:
            return {}   # no band structure: the gather eikonal route

    fn.prepare = prepare  # type: ignore[attr-defined]
    return fn
