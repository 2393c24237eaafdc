"""Layer framework: pure-function cost layers over an explicit dependency DAG
(port of mesh_navigation_tpu/layers/base.py:29-144).

A layer is (MeshArrays, {input layer outputs}, state) -> (costs[V],
lethal[V], vectors[V, 3]) (abstract_layer.h:55-280); the stack orders the
layers topologically (layer_manager.cpp:148-200) and evaluates them in that
order, so a change notification is a re-evaluation of the dependents.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from mesh_navigation_torch.config import LayerConfig
from mesh_navigation_torch.mesh.arrays import MeshArrays


class LayerOutput(NamedTuple):
    """What every layer produces (AbstractLayer::costs()/lethals()/vectorAt,
    abstract_layer.h:64-155)."""
    costs: torch.Tensor     # [V] f32
    lethal: torch.Tensor    # [V] bool
    vectors: torch.Tensor   # [V, 3] f32 repulsive field (zeros unless the
                            # layer provides one)


# a state key: layers that compute a repulsive vector field return zeros
# instead (a caller that reads only the costs, such as the live-replan step)
SKIP_VECTORS = "__skip_vectors__"


def zero_vectors(mesh: MeshArrays) -> torch.Tensor:
    return torch.zeros((mesh.num_vertices, 3), dtype=torch.float32, device=mesh.device)


# kind -> factory(config) -> LayerFn(mesh, inputs: dict[str, LayerOutput], state: dict)
LayerFn = Callable[[MeshArrays, dict, dict], LayerOutput]
LAYER_REGISTRY: dict[str, Callable[[LayerConfig], LayerFn]] = {}


def register_layer(kind: str):
    def deco(factory):
        LAYER_REGISTRY[kind] = factory
        return factory
    return deco


@dataclasses.dataclass
class LayerStack:
    """Topologically ordered layer composition (LayerManager equivalent).

    `prepare(mesh)` runs the host-side precomputation (raycast grids,
    Sethian plans); `compute(mesh, state)` evaluates the DAG and returns
    every layer's output plus the default layer's costs
    (MeshMap::copyVertexCostsFromDefaultLayer, mesh_map.cpp:495-515)."""

    configs: tuple[LayerConfig, ...]
    order: tuple[str, ...]
    fns: dict[str, LayerFn]
    default_layer: str

    @classmethod
    def from_configs(
        cls, configs: tuple[LayerConfig, ...], default_layer: Optional[str] = None
    ) -> "LayerStack":
        by_name = {c.name: c for c in configs}
        # Kahn topo sort over the `inputs` edges (layer_manager.cpp:148-200)
        indeg = {c.name: 0 for c in configs}
        dependents: dict[str, list[str]] = {c.name: [] for c in configs}
        for c in configs:
            for inp in c.inputs:
                if inp not in by_name:
                    raise ValueError(f"layer '{c.name}' depends on unknown layer '{inp}'")
                indeg[c.name] += 1
                dependents[inp].append(c.name)
        queue = [n for n, d in indeg.items() if d == 0]
        order: list[str] = []
        while queue:
            n = queue.pop(0)
            order.append(n)
            for d in dependents[n]:
                indeg[d] -= 1
                if indeg[d] == 0:
                    queue.append(d)
        if len(order) != len(configs):
            raise ValueError("layer dependency graph has a cycle")
        fns = {}
        for c in configs:
            if c.kind not in LAYER_REGISTRY:
                raise ValueError(f"unknown layer kind '{c.kind}' (have {sorted(LAYER_REGISTRY)})")
            fns[c.name] = LAYER_REGISTRY[c.kind](c)
        # default: the last layer in topo order (typically the combination)
        default = default_layer or (order[-1] if order else "")
        return cls(configs=configs, order=tuple(order), fns=fns, default_layer=default)

    def prepare(self, mesh: MeshArrays) -> dict:
        """Host-side precomputation shared by layers; returns the `state`
        dict threaded into `compute`."""
        state: dict = {}
        for c in self.configs:
            prep = getattr(self.fns[c.name], "prepare", None)
            if prep is not None:
                state.update(prep(mesh))
        return state

    def compute(
        self, mesh: MeshArrays, state: Optional[dict] = None
    ) -> tuple[dict[str, LayerOutput], torch.Tensor]:
        """Evaluate the DAG. Returns ({name: LayerOutput}, combined_costs[V])."""
        state = state or {}
        # per-layer combination weights (abstract_layer.h:180-183)
        state["__factors__"] = {c.name: c.factor for c in self.configs}
        outputs: dict[str, LayerOutput] = {}
        for name in self.order:
            cfg = next(c for c in self.configs if c.name == name)
            inputs = {i: outputs[i] for i in cfg.inputs}
            outputs[name] = self.fns[name](mesh, inputs, state)
        if self.default_layer and self.default_layer in outputs:
            combined = outputs[self.default_layer].costs
        else:
            combined = torch.zeros(mesh.num_vertices, dtype=torch.float32, device=mesh.device)
        return outputs, combined

    def combined_vectors(self, mesh: MeshArrays, outputs: dict[str, LayerOutput]) -> torch.Tensor:
        """Sum of all layers' repulsive vector fields (mesh_map.cpp:1070-1108)."""
        total = zero_vectors(mesh)
        for out in outputs.values():
            total = total + out.vectors
        return total
