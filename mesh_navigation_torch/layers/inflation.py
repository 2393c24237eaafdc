"""Geodesic inflation layer: wavefront distance from lethal seeds + cost
fading (port of mesh_navigation_tpu/layers/inflation.py:34-100, :225-267).

Parity with mesh_layers/src/inflation_layer.cpp: every input-layer lethal
vertex seeds the wave at distance 0, a Sethian wavefront bounded by the
inflation radius gives the distance (341-491), and the costmap_2d-style decay
turns it into cost (315-339). The wave runs as the shift-based banded Sethian
solve (ops/banded_sethian.py). The gather eikonal route for meshes without
band structure and the repulsive vector field (277-308) are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mesh_navigation_torch.config import LayerConfig
from mesh_navigation_torch.layers.base import LayerOutput, register_layer, zero_vectors
from mesh_navigation_torch.mesh.arrays import MeshArrays
from mesh_navigation_torch.ops import banded_sethian as _bs

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
    (inflation_layer.cpp:452), by the banded Sethian solve capped at the
    inflation radius. `window` runs it on a sub-plane around the lethal set,
    certified exact with a full-plane fallback."""
    if sethian_plan is None:
        raise NotImplementedError(
            "inflation without a banded Sethian plan (the gather eikonal route)"
        )
    seed = torch.where(lethal, 0.0, INF).to(torch.float32)
    return _bs.sethian_distances_banded(
        sethian_plan, seed, source_cap=p.inflation_radius, window=window,
    )


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
    if p.repulsive_field:
        raise NotImplementedError(
            f"inflation layer '{cfg.name}': the repulsive vector field is not "
            "ported yet; set repulsive_field to 0"
        )

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
        vectors = zero_vectors(mesh)
        # distances for vectorAt-style lookups
        state[f"inflation:{cfg.name}"] = (dist, vectors)
        return LayerOutput(costs=costs, lethal=lethal, vectors=vectors)

    def prepare(m: MeshArrays) -> dict:
        try:
            return {"__sethian_plan__": _bs.build_sethian_plan(m)}
        except ValueError:
            return {}   # no band structure: inflation_distances raises

    fn.prepare = prepare  # type: ignore[attr-defined]
    return fn
