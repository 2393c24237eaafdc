from mesh_navigation_torch.control.controller import ControllerState, MeshController

__all__ = ["ControllerState", "MeshController"]
