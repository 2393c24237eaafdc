"""Port vs reference: the entry layer. Mesh files (mesh/io.py), the HDF5
working file and the server's save_map, the viz exports, the CLI and the
CPU oracles.

Every loader reads the same file on both sides (written to tmp_path) and
must give the same arrays; the working file written by one package is read
back by the other; viz files and the CLI's exports are held byte for byte;
the oracles' outputs bit for bit."""

import json
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mesh_navigation_tpu import cli as jcli
from mesh_navigation_tpu.api.server import MeshNavServer as JServer
from mesh_navigation_tpu.config import LayerConfig as JLayerConfig
from mesh_navigation_tpu.config import NavConfig as JNavConfig
from mesh_navigation_tpu.mesh import io as jio
from mesh_navigation_tpu.mesh import synthetic
from mesh_navigation_tpu.ops import sweeps as jsweeps
from mesh_navigation_tpu.utils import oracle as joracle
from mesh_navigation_tpu.utils import viz as jviz

from mesh_navigation_torch import cli as tcli
from mesh_navigation_torch.api.server import MeshNavServer
from mesh_navigation_torch.config import LayerConfig, NavConfig
from mesh_navigation_torch.mesh import io as tio
from mesh_navigation_torch.mesh.arrays import build_mesh, host_array
from mesh_navigation_torch.utils import oracle as toracle
from mesh_navigation_torch.utils import viz as tviz

from test_torch_reference import reference_build_mesh

torch.set_num_threads(2)


def _terrain(n=12, seed=2):
    return synthetic.terrain_mesh(n, n, spacing=0.5, hills=1.5, roughness=0.02, seed=seed)


def _same_load(path, loader):
    v_j, f_j = getattr(jio, loader)(str(path))
    v_t, f_t = getattr(tio, loader)(str(path))
    assert v_t.dtype == np.asarray(v_j).dtype and f_t.dtype == np.asarray(f_j).dtype
    np.testing.assert_array_equal(v_t, v_j)
    np.testing.assert_array_equal(f_t, f_j)
    v_i, f_i = tio.import_mesh_file(str(path))
    np.testing.assert_array_equal(v_i, v_t)
    np.testing.assert_array_equal(f_i, f_t)
    return v_t, f_t


def _polygons(v, f):
    """The triangles of f with every third pair of neighbours merged into a
    quad (a, b, c, d) where they share an edge, and one pentagon: a mixed
    polygon list."""
    polys = [list(t) for t in f[:-6]]
    polys += [[int(f[-6][0]), int(f[-6][1]), int(f[-6][2]), int(f[-5][2])]]
    polys += [[int(x) for x in f[-4]] + [int(f[-3][2]), int(f[-2][2])]]
    return polys


def test_obj_loader(tmp_path):
    v, f = _terrain()
    p = tmp_path / "m.obj"
    with open(p, "w") as fh:
        fh.write("# comment\no terrain\n")
        for x, y, z in v:
            fh.write(f"v {x} {y} {z}\n")
        fh.write("vn 0 0 1\n")
        for poly in _polygons(v, f):
            fh.write("f " + " ".join(f"{i + 1}/{i + 1}/1" for i in poly) + "\n")
    v_t, f_t = _same_load(p, "load_obj")
    assert len(v_t) == len(v) and len(f_t) == len(f) - 6 + 2 + 3


def _ply_header(fh, fmt, nv, nf, cnt="uchar", idx="int", extra_vertex=""):
    fh.write(f"ply\nformat {fmt} 1.0\ncomment test\nelement vertex {nv}\n".encode())
    fh.write(f"property float x\nproperty float y\nproperty float z\n{extra_vertex}".encode())
    fh.write(f"element face {nf}\nproperty list {cnt} {idx} vertex_indices\nend_header\n".encode())


def test_ply_ascii_loader(tmp_path):
    v, f = _terrain()
    polys = _polygons(v, f)
    p = tmp_path / "a.ply"
    with open(p, "wb") as fh:
        _ply_header(fh, "ascii", len(v), len(polys))
        for x, y, z in v:
            fh.write(f"{x} {y} {z}\n".encode())
        for poly in polys:
            fh.write((f"{len(poly)} " + " ".join(map(str, poly)) + "\n").encode())
    _same_load(p, "load_ply")


@pytest.mark.parametrize("kind", ["triangles", "mixed", "ushort_uint_normals"])
def test_ply_binary_loader(tmp_path, kind):
    """All-triangle lists take the one-read route, mixed polygon lists the
    per-face walk; both give the reference's faces in its order. The third
    case has uint indices, a ushort count and vertex normals and colours."""
    v, f = _terrain()
    polys = [list(t) for t in f] if kind != "mixed" else _polygons(v, f)
    cnt, idx = ("ushort", "uint") if kind.startswith("ushort") else ("uchar", "int")
    extra = ("property float nx\nproperty float ny\nproperty float nz\nproperty uchar red\n"
             if kind.startswith("ushort") else "")
    p = tmp_path / "b.ply"
    with open(p, "wb") as fh:
        _ply_header(fh, "binary_little_endian", len(v), len(polys), cnt, idx, extra)
        for x, y, z in v:
            fh.write(struct.pack("<3f", x, y, z))
            if extra:
                fh.write(struct.pack("<3fB", 0.0, 0.0, 1.0, 7))
        for poly in polys:
            fh.write(struct.pack("<H" if cnt == "ushort" else "<B", len(poly)))
            fh.write(struct.pack(f"<{len(poly)}{'I' if idx == 'uint' else 'i'}", *poly))
    v_t, f_t = _same_load(p, "load_ply")
    np.testing.assert_array_equal(v_t, v.astype(np.float32))
    if kind != "mixed":
        np.testing.assert_array_equal(f_t, f)


def test_off_loader(tmp_path):
    v, f = _terrain()
    p = tmp_path / "m.off"
    with open(p, "w") as fh:
        fh.write(f"OFF\n# counts\n{len(v)} {len(f) - 6 + 2} 0\n")
        for x, y, z in v:
            fh.write(f"{x} {y} {z}\n")
        for poly in _polygons(v, f):
            fh.write(f"{len(poly)} " + " ".join(map(str, poly)) + "\n")
    _same_load(p, "load_off")
    bad = tmp_path / "bad.off"
    bad.write_text("NOFF\n0 0 0\n")
    with pytest.raises(ValueError, match="not an OFF"):
        tio.load_off(str(bad))


@pytest.mark.parametrize("form", ["binary", "ascii"])
def test_stl_loader(tmp_path, form):
    v, f = _terrain(8)
    tris = v[f].astype(np.float32)
    p = tmp_path / "m.stl"
    if form == "binary":
        with open(p, "wb") as fh:
            fh.write(b"\0" * 80)
            fh.write(struct.pack("<I", len(tris)))
            for t in tris:
                fh.write(struct.pack("<3f", 0, 0, 1))
                for x in t:
                    fh.write(struct.pack("<3f", *x))
                fh.write(struct.pack("<H", 0))
    else:
        lines = ["solid terrain"]
        for t in tris:
            lines += ["facet normal 0 0 1", " outer loop"]
            lines += [f"  vertex {x} {y} {z}" for x, y, z in t]
            lines += [" endloop", "endfacet"]
        p.write_text("\n".join(lines + ["endsolid terrain"]))
    v_t, f_t = _same_load(p, "load_stl")
    assert len(v_t) == len(v)


DAE = """<?xml version="1.0"?>
<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" version="1.4.1">
 <asset><up_axis>Y_UP</up_axis></asset>
 <library_geometries>
  <geometry id="quad"><mesh>
   <source id="pos"><float_array id="arr" count="15">0 0 0 1 0 0 1 1 0 0 1 0 0.5 1.5 0.2</float_array></source>
   <vertices id="vv"><input semantic="POSITION" source="#pos"/></vertices>
   <polylist count="2"><input semantic="VERTEX" source="#vv" offset="0"/>
    <input semantic="NORMAL" source="#nrm" offset="1"/>
    <vcount>4 3</vcount><p>0 0 1 0 2 0 3 0 3 0 2 0 4 0</p></polylist>
   <triangles count="1"><input semantic="VERTEX" source="#vv" offset="0"/><p>0 2 4</p></triangles>
  </mesh></geometry>
  <geometry id="fan"><mesh>
   <source id="p2"><float_array id="a2" count="12">0 0 1 2 0 1 2 2 1 0 2 1</float_array></source>
   <vertices id="v2"><input semantic="POSITION" source="#p2"/></vertices>
   <polygons count="1"><input semantic="VERTEX" source="#v2" offset="0"/><p>0 1 2 3</p></polygons>
  </mesh></geometry>
 </library_geometries>
 <library_visual_scenes><visual_scene id="s">
  <node id="n"><translate>10 0 0</translate><rotate>0 0 1 30</rotate><scale>2 1 1</scale>
   <instance_geometry url="#quad"/>
   <node id="c"><matrix>1 0 0 0 0 1 0 5 0 0 1 0 0 0 0 1</matrix><instance_geometry url="#fan"/></node>
  </node>
 </visual_scene></library_visual_scenes>
 <scene><instance_visual_scene url="#s"/></scene>
</COLLADA>"""


def test_dae_loader(tmp_path):
    """Polylist, triangles and polygons primitives, nested nodes with
    translate / rotate / scale / matrix transforms, and the Y_UP turn."""
    p = tmp_path / "m.dae"
    p.write_text(DAE)
    v_t, f_t = _same_load(p, "load_dae")
    assert len(v_t) == 2 * 5 + 4 and len(f_t) == 2 + 1 + 1 + 2   # each primitive its sources


def test_import_refuses_an_unknown_format(tmp_path):
    with pytest.raises(ValueError, match="unsupported"):
        tio.import_mesh_file(str(tmp_path / "m.xyz"))


def _steepness_pair(v, f):
    cfg = dict(layers=(("steepness", "steepness"), ("border", "border")))
    tsrv = MeshNavServer(build_mesh(v, f, device="cpu"), NavConfig(
        layers=tuple(LayerConfig(name=n, kind=k) for n, k in cfg["layers"])),
        planner_kind="dijkstra", device="cpu")
    jsrv = JServer(reference_build_mesh(v, f), JNavConfig(
        layers=tuple(JLayerConfig(name=n, kind=k) for n, k in cfg["layers"])),
        planner_kind="dijkstra")
    return tsrv, jsrv


def test_working_file_and_save_map_read_by_the_other_package(tmp_path):
    """read_map persists the working file on first load and reloads from it;
    each package reads what the other wrote (geometry, cached artifacts and
    the save_map channels)."""
    v, f = _terrain()
    src = tmp_path / "m.ply"
    tviz.write_cost_ply(str(src), v, f, np.zeros(len(v)))
    wt, wj = tmp_path / "t.h5", tmp_path / "j.h5"
    mt = tio.read_map(str(src), str(wt), device="cpu")
    mj = jio.read_map(str(src), str(wj))
    for path in (wt, wj):
        for load in (tio.load_h5_geometry, jio.load_h5_geometry):
            gv, gf = load(str(path))
            np.testing.assert_array_equal(gv, host_array(mt, "vertices"))
            np.testing.assert_array_equal(gf, host_array(mt, "faces"))
    again = tio.read_map("does-not-exist.ply", str(wj), device="cpu")
    np.testing.assert_array_equal(host_array(again, "edges"), np.asarray(mj.edges))
    import h5py

    with h5py.File(wt, "r") as ht, h5py.File(wj, "r") as hj:
        for key in ("vertices", "faces", "face_normals", "vertex_normals", "edge_distances"):
            np.testing.assert_allclose(ht["mesh"][key][()], hj["mesh"][key][()], rtol=0,
                                       atol=1e-6)
    tsrv, jsrv = _steepness_pair(v, f)
    st, sj = tmp_path / "save_t.h5", tmp_path / "save_j.h5"
    assert tsrv.save_map(str(st)) and jsrv.save_map(str(sj))
    for name in ("steepness", "border", "vertex_costs"):
        a = jio.load_channel(str(st), name)
        b = tio.load_channel(str(sj), name)
        assert a is not None and b is not None
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(tio.load_channel(str(st), name), a)
    assert tio.load_channel(str(st), "absent") is None
    assert tio.load_channel(str(tmp_path / "none.h5"), "steepness") is None


def test_viz_files_are_the_references_bytes(tmp_path):
    v, f = _terrain(16)
    rng = np.random.default_rng(0)
    costs = rng.uniform(0, 3, len(v))
    costs[::17] = np.inf
    vec = rng.normal(size=(len(v), 3)).astype(np.float32)
    vec[::5] = 0.0
    pos = (v[:40] * np.float32(1.5) - np.float32(1e-5)).astype(np.float32)
    valid = rng.uniform(size=40) < 0.8
    np.testing.assert_array_equal(tviz.rainbow_color(costs), jviz.rainbow_color(costs))
    writes = [
        ("c.ply", lambda m, p: m.write_cost_ply(p, v, f, costs)),
        ("raw.ply", lambda m, p: m.write_cost_ply(p, v, f, costs / 3, normalize=False)),
        ("vf.obj", lambda m, p: m.write_vector_field_obj(p, v, vec, scale=0.3, stride=2)),
        ("path.obj", lambda m, p: m.write_path_obj(p, pos, valid)),
        ("all.obj", lambda m, p: m.write_path_obj(p, pos)),
        ("none.obj", lambda m, p: m.write_path_obj(p, pos, np.zeros(40, bool))),
    ]
    for name, write in writes:
        a, b = tmp_path / f"t_{name}", tmp_path / f"j_{name}"
        write(tviz, str(a))
        write(jviz, str(b))
        assert a.read_bytes() == b.read_bytes(), name


@pytest.mark.parametrize("planner", ["dijkstra", "cvp"])
def test_cli_on_a_synthetic_map_as_the_reference(tmp_path, capsys, planner):
    """--synthetic 32 --device cpu: the reference CLI's JSON keys, outcome,
    path points and exit code; the four exports written, byte for byte the
    reference's."""
    common = ["--synthetic", "32", "--start", "1", "1", "0", "--goal", "12", "12", "0",
              "--planner", planner, "--layers", "steepness,border"]
    rc_t = tcli.main(common + ["--device", "cpu", "--out", str(tmp_path / "t")])
    out_t = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rc_j = jcli.main(common + ["--out", str(tmp_path / "j")])
    out_j = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc_t == rc_j == 0
    assert set(out_t) == set(out_j)
    assert out_t["outcome"] == out_j["outcome"] == "SUCCESS"
    assert out_t["path_points"] == out_j["path_points"]
    assert out_t["cost"] == pytest.approx(out_j["cost"], rel=1e-5)
    exact = ("vertex_costs.ply", "potential.ply", "vector_field.obj", "path.obj")
    if planner == "cvp":
        # the CVP field, its vectors and its descent agree within the
        # port's CVP bound (0.5%, ROADMAP "Tests"), not bit for bit: the
        # exports' numbers are held there (5e-3 absolute for the vectors'
        # components), their layout exactly
        exact = ("vertex_costs.ply",)
        for name in ("potential.ply", "vector_field.obj", "path.obj"):
            a = (tmp_path / "t" / name).read_text().split("\n")
            b = (tmp_path / "j" / name).read_text().split("\n")
            assert len(a) == len(b)
            assert [x.split()[:1] for x in a] == [x.split()[:1] for x in b]
            num = [(float(p), float(q)) for x, y in zip(a, b) if x[:1] in "v-0123456789" and x
                   for p, q in zip(x.split()[x[0] == "v":], y.split()[y[0] == "v":])]
            np.testing.assert_allclose(*zip(*num), rtol=5e-3, atol=5e-3)
    for name in exact:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name


def test_cli_reads_a_mesh_file_and_fails_where_the_goal_is_unreachable(tmp_path, capsys):
    """--mesh with a working file (written, then reused) and a rollout; a
    goal on a second, disconnected terrain gives NO_PATH_FOUND and exit 1,
    as the reference's CLI does."""
    v, f = _terrain(16)
    v2 = v + np.asarray([20.0, 0, 0], np.float32)
    path = tmp_path / "two.ply"
    tviz.write_cost_ply(str(path), np.concatenate([v, v2]),
                        np.concatenate([f, f + len(v)]), np.zeros(2 * len(v)))
    base = ["--mesh", str(path), "--working-file", str(tmp_path / "w.h5"), "--planner",
            "dijkstra", "--start", "1", "1", "0"]
    for run in range(2):
        rc = tcli.main(base + ["--goal", "6", "6", "0", "--rollout", "20", "--device", "cpu"])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 0 and out["outcome"] == "SUCCESS" and "rollout_final_dist_to_goal" in out
    rc_t = tcli.main(base + ["--goal", "26", "6", "0", "--device", "cpu"])
    out_t = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rc_j = jcli.main(base + ["--goal", "26", "6", "0"])
    out_j = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc_t == rc_j == 1 and out_t["outcome"] == out_j["outcome"] == "NO_PATH_FOUND"


def test_oracles_are_the_references_bit_for_bit():
    v, f = synthetic.irregular_terrain_mesh(14, 12, spacing=0.5, hills=1.0, seed=3)
    jm = reference_build_mesh(v, f)
    tm = build_mesh(v, f, device="cpu")
    adj = toracle.mesh_adjacency(tm)
    assert adj == joracle.mesh_adjacency(jm)
    vf = toracle.mesh_vertex_faces(tm)
    assert vf == joracle.mesh_vertex_faces(jm)
    rng = np.random.default_rng(1)
    costs = rng.uniform(0, 1.2, len(v)).astype(np.float32)
    ew = np.asarray(jsweeps.compute_edge_weights(jm, jnp.asarray(costs), 1.0))
    faces, fe = host_array(tm, "faces"), host_array(tm, "face_edges")
    for seed in (0, 57, 100):
        for a, b in zip(toracle.dijkstra_oracle(len(v), adj, ew, costs, seed, 1.0),
                        joracle.dijkstra_oracle(len(v), adj, ew, costs, seed, 1.0)):
            np.testing.assert_array_equal(a, b)
    seeds = ([3, 4, 20], [0.0, 0.1, 0.05])
    for a, b in zip(toracle.cvp_oracle(faces, fe, vf, ew, costs, *seeds, cost_limit=1.0),
                    joracle.cvp_oracle(faces, fe, vf, ew, costs, *seeds, cost_limit=1.0)):
        np.testing.assert_array_equal(a, b)
    lethal = costs > 1.1
    ed = host_array(tm, "edge_dist")
    np.testing.assert_array_equal(toracle.inflation_oracle(faces, fe, vf, ed, lethal, 2.0),
                                  joracle.inflation_oracle(faces, fe, vf, ed, lethal, 2.0))
