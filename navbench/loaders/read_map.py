"""The map file read as a robot's map server reads it: mesh/io.read_map."""


def load(path, device):
    from mesh_navigation_torch.mesh import io

    return io.read_map(path, device=device)
