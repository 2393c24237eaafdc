from mesh_navigation_torch.api.outcomes import Outcome

__all__ = ["Outcome"]
