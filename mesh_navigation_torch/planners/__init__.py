from mesh_navigation_torch.planners.dijkstra import DijkstraPlanner

__all__ = ["DijkstraPlanner"]
