"""A scanned-like terrain: the program's synthetic.irregular_terrain_mesh
(jittered points of an nx x ny grid, Delaunay-triangulated)."""


def make(*, nx, ny, **params):
    from mesh_navigation_torch.mesh import synthetic

    return synthetic.irregular_terrain_mesh(nx, ny, **params)
