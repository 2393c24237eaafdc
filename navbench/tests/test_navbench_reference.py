"""The reference agrees with the port's CPU path on a 32 x 32 map, its
control (the program's bfloat16 fields) does not, and it imports nothing
of the program, JAX or the JAX package."""

import sys
import time

import pytest
import torch

from conftest import small
from navbench import harness
from navbench import spec
from navbench.reference import imports
from navbench.reference.mesh import RefMesh

SEED = 2**31 + 4242
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def run(cell_name, cache_root, control=None, seconds=1.0, **kw):
    s = small(cell_name, **kw)
    return harness.run_cell(cell=s["cell"], config=s["config"], mix=s["mix"],
                            limits=s["limits"], seed=SEED, seconds=seconds, trace=False,
                            device=torch.device("cpu"), t_start=time.perf_counter(),
                            bench=s["bench"], root=cache_root, control=control)


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_port_on_the_cpu_is_correct(cell_name, cache_root):
    res = run(cell_name, cache_root)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert "setup_s" in res["metrics"] and len(res["metrics"]) >= 2


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_is_not_correct(cell_name, cache_root):
    res = run(cell_name, cache_root, control="bf16", n=48)
    assert not res["correct"], res["checks"]
    assert res["checks"]["field_gap"]["value"] > res["checks"]["field_gap"]["limit"]


def test_the_reference_imports_nothing_forbidden(tmp_path):
    assert imports.forbidden() == []
    tops = {m.split(".")[0] for mods in imports.imported().values() for m in mods}
    assert tops - set(sys.stdlib_module_names) == {"numpy", "scipy", "navbench"}
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "bad.py").write_text(
        "import mesh_navigation_torch.ops\nfrom jax import numpy\nfrom navbench import harness\n")
    (tmp_path / "fine.py").write_text(
        "import mesh_navigation_torchvision\nfrom navbench.reference import layers\n")
    assert imports.forbidden(str(tmp_path)) == [
        "sub/bad.py: jax", "sub/bad.py: mesh_navigation_torch.ops", "sub/bad.py: navbench"]


def test_locate_follows_the_nearest_vertex_search():
    """The reference finds a robot's face as MeshMap's search does: around
    the nearest vertex, else off the map; on a Delaunay map some points on
    the surface are off it. The port's search agrees point for point."""
    from mesh_navigation_torch.mesh import query, synthetic
    from mesh_navigation_torch.mesh.arrays import build_mesh
    from navbench.reference.control import locate

    v, f = synthetic.irregular_terrain_mesh(24, 24, spacing=0.5, jitter=0.45, hills=2.0,
                                            roughness=0.01, seed=1)
    mix = dict(spec.traffic("fleet4096"), lanes=400)
    d = spec.kind(mix).Traffic(mix, v, f, 2**31 + 3).draw()
    mesh = build_mesh(v, f, device="cpu")
    face, _, _, found = query.containing_face_batch(mesh, query.build_grid(mesh),
                                                    torch.from_numpy(d["starts"]), 0.4)
    ref = RefMesh(v, f)
    fixes = [locate(ref, p, 0.4) for p in d["starts"]]
    assert [x is not None for x in fixes] == found.tolist()
    got = [sorted(mesh.faces[i].tolist()) for i in face[found].tolist()]
    assert got == [sorted(f[x[0]].tolist()) for x in fixes if x is not None]
    assert 0 < sum(x is None for x in fixes) < len(fixes) // 4
