from mesh_navigation_torch.planners.cvp import CVPPlanner
from mesh_navigation_torch.planners.dijkstra import DijkstraPlanner

__all__ = ["CVPPlanner", "DijkstraPlanner"]
