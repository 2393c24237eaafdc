"""A gridded terrain: the program's synthetic.terrain_mesh (an nx x ny
grid of hills and noise)."""


def make(*, nx, ny, **params):
    from mesh_navigation_torch.mesh import synthetic

    return synthetic.terrain_mesh(nx, ny, **params)
