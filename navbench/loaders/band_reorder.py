"""The map file's mesh band-reordered at load (mesh/reorder), as a scanned
map is served: vertices put in row bands so the banded plan covers it."""


def load(path, device):
    from mesh_navigation_torch.mesh import io, reorder

    v, f = io.import_mesh_file(path)
    return reorder.build_reordered_mesh(v, f, device=device)
