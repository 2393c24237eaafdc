"""Mesh files and the HDF5 working file (port of mesh_navigation_tpu/mesh/io.py).

The map-load pipeline (mesh_map.cpp:149-260): a source mesh file is imported
(OBJ, PLY in ASCII or binary little-endian, OFF, STL in both forms, COLLADA
with its node transforms baked, or an HDF5 working file) and copied into an
HDF5 working file, so the source is never changed; computed artifacts
(normals, edge distances, per-layer cost channels) are cached there as
named channels (mesh_map.cpp:342-425). numpy and the standard library; h5py
is imported only inside the HDF5 functions, which raise RuntimeError where
it is missing (load_channel returns None, as the reference's does).

Departure (same output, faster): a binary PLY whose faces are all triangles
is read with one structured np.frombuffer instead of one face at a time; a
mixed-polygon list keeps the per-face loop. `read_map` builds the mesh on
the caller's device (default: the card).
"""

from __future__ import annotations

import os

import numpy as np

from mesh_navigation_torch.mesh.arrays import MeshArrays, build_mesh, host_array


# --------------------------------------------------------------------------
# plain-text importers (assimp equivalents for the common formats)
# --------------------------------------------------------------------------

def load_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Wavefront OBJ triangles (v / f records; polygons fan-triangulated)."""
    verts: list[list[float]] = []
    faces: list[list[int]] = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [int(p.split("/")[0]) - 1 for p in line.split()[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return (
        np.asarray(verts, np.float32),
        np.asarray(faces, np.int32) if faces else np.zeros((0, 3), np.int32),
    )


def load_ply(path: str) -> tuple[np.ndarray, np.ndarray]:
    """ASCII or binary-little-endian PLY triangle meshes."""
    with open(path, "rb") as fh:
        header: list[str] = []
        while True:
            line = fh.readline().decode("ascii", "replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        counts = {}
        props: dict[str, list[tuple[str, str]]] = {}
        cur = None
        for l in header:
            if l.startswith("element"):
                _, name, n = l.split()
                counts[name] = int(n)
                cur = name
                props[name] = []
            elif l.startswith("property") and cur:
                parts = l.split()
                if parts[1] == "list":
                    props[cur].append(("list", parts[2] + ":" + parts[3]))
                else:
                    props[cur].append((parts[1], parts[2]))
        nv, nf = counts.get("vertex", 0), counts.get("face", 0)
        vprops = props.get("vertex", [])
        if fmt == "ascii":
            verts = np.zeros((nv, 3), np.float32)
            names = [p[1] for p in vprops]
            xi, yi, zi = names.index("x"), names.index("y"), names.index("z")
            for i in range(nv):
                vals = fh.readline().split()
                verts[i] = [float(vals[xi]), float(vals[yi]), float(vals[zi])]
            faces = []
            for _ in range(nf):
                vals = fh.readline().split()
                n = int(vals[0])
                idx = [int(x) for x in vals[1 : 1 + n]]
                for k in range(1, n - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
            return verts, np.asarray(faces, np.int32) if faces else np.zeros((0, 3), np.int32)
        # binary little endian
        type_map = {
            "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
            "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
            "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
            "uint": "<u4", "uint32": "<u4",
        }
        vdt = np.dtype([(name, type_map[t]) for t, name in vprops])
        vdata = np.frombuffer(fh.read(vdt.itemsize * nv), dtype=vdt, count=nv)
        verts = np.stack(
            [vdata["x"], vdata["y"], vdata["z"]], axis=1
        ).astype(np.float32)
        fprops = props.get("face", [])
        cnt_t, idx_t = fprops[0][1].split(":") if fprops and fprops[0][0] == "list" else ("uchar", "int")
        return verts, _binary_faces(fh.read(), nf, np.dtype(type_map[cnt_t]),
                                    np.dtype(type_map[idx_t]))


def _binary_faces(buf: bytes, nf: int, cnt_dt: np.dtype, idx_dt: np.dtype) -> np.ndarray:
    """The [F, 3] int32 triangles of a binary PLY face list of nf records
    (a count, then that many indices), fan-triangulated. Where every record
    is a triangle, one structured read: record k then starts at k times the
    record size, and reading nf such records gives all counts 3 only if the
    list holds nothing else. Otherwise the reference's per-face walk."""
    tri = np.dtype([("n", cnt_dt), ("i", idx_dt, (3,))])
    if nf and len(buf) >= nf * tri.itemsize:
        rec = np.frombuffer(buf, dtype=tri, count=nf)
        if (rec["n"] == 3).all():
            return rec["i"].astype(np.int32)
    faces = []
    pos = 0
    for _ in range(nf):
        n = int(np.frombuffer(buf, dtype=cnt_dt, count=1, offset=pos)[0])
        pos += cnt_dt.itemsize
        idx = np.frombuffer(buf, dtype=idx_dt, count=n, offset=pos)
        pos += idx_dt.itemsize * n
        for k in range(1, n - 1):
            faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(faces, np.int32) if faces else np.zeros((0, 3), np.int32)


def load_off(path: str) -> tuple[np.ndarray, np.ndarray]:
    with open(path) as fh:
        tokens: list[str] = []
        for line in fh:
            line = line.split("#")[0].strip()
            if line:
                tokens += line.split()
    if not tokens or tokens[0] != "OFF":
        raise ValueError(f"{path}: not an OFF file")
    nv, nf = int(tokens[1]), int(tokens[2])
    pos = 4
    verts = np.asarray(tokens[pos : pos + nv * 3], np.float32).reshape(nv, 3)
    pos += nv * 3
    faces = []
    for _ in range(nf):
        n = int(tokens[pos])
        idx = [int(t) for t in tokens[pos + 1 : pos + 1 + n]]
        pos += n + 1
        for k in range(1, n - 1):
            faces.append([idx[0], idx[k], idx[k + 1]])
    return verts, np.asarray(faces, np.int32) if faces else np.zeros((0, 3), np.int32)


def load_stl(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Binary or ASCII STL. STL stores loose triangles; identical vertices
    are welded (exact-match) so the result has real shared topology."""
    with open(path, "rb") as fh:
        head = fh.read(5)
        fh.seek(0)
        if head == b"solid":
            # could still be binary with a 'solid' header: sniff for 'facet'
            text = fh.read()
            if b"facet" in text[:2048]:
                tokens = text.decode("ascii", "replace").split()
                tris = []
                i = 0
                while i < len(tokens):
                    if tokens[i] == "vertex":
                        tris.append(
                            [float(tokens[i + 1]), float(tokens[i + 2]), float(tokens[i + 3])]
                        )
                        i += 4
                    else:
                        i += 1
                pts = np.asarray(tris, np.float32).reshape(-1, 3, 3)
                return _weld_triangles(pts)
            fh.seek(0)
        fh.seek(80)
        (n,) = np.frombuffer(fh.read(4), "<u4")
        rec = np.dtype(
            [("n", "<f4", 3), ("v", "<f4", (3, 3)), ("attr", "<u2")]
        )
        data = np.frombuffer(fh.read(rec.itemsize * int(n)), dtype=rec, count=int(n))
        return _weld_triangles(data["v"].astype(np.float32))


def _weld_triangles(pts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[T, 3, 3] loose triangle soup -> (vertices, faces) with exact welding."""
    flat = pts.reshape(-1, 3)
    verts, inverse = np.unique(flat, axis=0, return_inverse=True)
    faces = inverse.reshape(-1, 3).astype(np.int32)
    return verts.astype(np.float32), faces


def _strip_tag(el) -> str:
    return el.tag.split("}")[-1]


def load_dae(path: str) -> tuple[np.ndarray, np.ndarray]:
    """COLLADA (.dae) triangle meshes with scene-graph transform baking.

    Mirrors what the reference gets from assimp at map load — geometry
    extraction with node transforms applied and everything merged into one
    mesh (util.cpp:98-219 getMeshFromAssimpScene / transform bake). Handles
    <triangles>, <polylist> and <polygons> primitives (fan-triangulated),
    <matrix>/<translate>/<rotate>/<scale> node transforms, and Y_UP -> Z_UP
    conversion per <asset><up_axis>."""
    import xml.etree.ElementTree as ET

    root = ET.parse(path).getroot()

    def children(el, tag):
        return [c for c in el if _strip_tag(c) == tag]

    def find_all(el, tag):
        return [c for c in el.iter() if _strip_tag(c) == tag]

    # geometry id -> (verts [N,3], faces [M,3])
    geoms: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    for geom in find_all(root, "geometry"):
        gid = geom.get("id", "")
        for mesh_el in children(geom, "mesh"):
            sources = {}
            for src in children(mesh_el, "source"):
                arrs = children(src, "float_array")
                if arrs:
                    vals = np.asarray((arrs[0].text or "").split(), np.float64)
                    sources["#" + src.get("id", "")] = vals.reshape(-1, 3)
            pos_source = None
            vert_id = None
            for v_el in children(mesh_el, "vertices"):
                vert_id = "#" + v_el.get("id", "")
                for inp in children(v_el, "input"):
                    if inp.get("semantic") == "POSITION":
                        pos_source = inp.get("source")
            verts_list: list[np.ndarray] = []
            faces_list: list[list[int]] = []
            base = 0
            for prim in mesh_el:
                tag = _strip_tag(prim)
                if tag not in ("triangles", "polylist", "polygons"):
                    continue
                v_off, stride, src_ref = 0, 1, None
                for inp in children(prim, "input"):
                    off = int(inp.get("offset", 0))
                    stride = max(stride, off + 1)
                    if inp.get("semantic") == "VERTEX":
                        v_off = off
                        src_ref = inp.get("source")
                src_key = pos_source if src_ref in (vert_id, None) else src_ref
                pos = sources.get(src_key or "", None)
                if pos is None:
                    continue
                verts_list.append(pos.astype(np.float32))
                if tag == "polygons":
                    polys = [
                        np.asarray((p.text or "").split(), np.int64)[v_off::stride]
                        for p in children(prim, "p")
                    ]
                else:
                    p_els = children(prim, "p")
                    idx = np.asarray(
                        (p_els[0].text or "").split(), np.int64
                    )[v_off::stride] if p_els else np.zeros(0, np.int64)
                    if tag == "polylist":
                        vc_els = children(prim, "vcount")
                        vcount = np.asarray(
                            (vc_els[0].text or "").split(), np.int64
                        ) if vc_els else np.full(len(idx) // 3, 3, np.int64)
                        polys, c = [], 0
                        for n in vcount:
                            polys.append(idx[c : c + n])
                            c += n
                    else:
                        polys = [idx[k : k + 3] for k in range(0, len(idx), 3)]
                for poly in polys:
                    for k in range(1, len(poly) - 1):
                        faces_list.append(
                            [base + poly[0], base + poly[k], base + poly[k + 1]]
                        )
                base += len(pos)
            if verts_list:
                geoms[gid] = (
                    np.concatenate(verts_list),
                    np.asarray(faces_list, np.int32)
                    if faces_list
                    else np.zeros((0, 3), np.int32),
                )

    # scene instancing with baked transforms
    def node_transform(node) -> np.ndarray:
        T = np.eye(4)
        for el in node:
            tag = _strip_tag(el)
            vals = np.asarray((el.text or "").split(), np.float64)
            if tag == "matrix" and vals.size == 16:
                T = T @ vals.reshape(4, 4)
            elif tag == "translate" and vals.size == 3:
                M = np.eye(4)
                M[:3, 3] = vals
                T = T @ M
            elif tag == "rotate" and vals.size == 4:
                axis = vals[:3] / max(np.linalg.norm(vals[:3]), 1e-12)
                ang = np.deg2rad(vals[3])
                K = np.array(
                    [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
                )
                R = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * (K @ K)
                M = np.eye(4)
                M[:3, :3] = R
                T = T @ M
            elif tag == "scale" and vals.size == 3:
                T = T @ np.diag([*vals, 1.0])
        return T

    all_v: list[np.ndarray] = []
    all_f: list[np.ndarray] = []
    base = 0

    def visit(node, T):
        nonlocal base
        T = T @ node_transform(node)
        for el in node:
            tag = _strip_tag(el)
            if tag == "instance_geometry":
                gid = (el.get("url") or "").lstrip("#")
                if gid in geoms:
                    v, f = geoms[gid]
                    vh = np.concatenate([v, np.ones((len(v), 1), np.float32)], axis=1)
                    all_v.append((vh @ T.T[:, :3]).astype(np.float32))
                    all_f.append(f + base)
                    base += len(v)
            elif tag == "node":
                visit(el, T)

    scenes = find_all(root, "visual_scene")
    if scenes:
        for scene in scenes:
            for node in children(scene, "node"):
                visit(node, np.eye(4))
    if not all_v:  # no scene instancing: take the geometries as-is
        for v, f in geoms.values():
            all_v.append(v)
            all_f.append(f + base)
            base += len(v)

    verts = np.concatenate(all_v) if all_v else np.zeros((0, 3), np.float32)
    faces = np.concatenate(all_f) if all_f else np.zeros((0, 3), np.int32)

    up = [el for el in root.iter() if _strip_tag(el) == "up_axis"]
    if up and (up[0].text or "").strip() == "Y_UP":
        # rotate into the Z-up robotics frame: (x, y, z) -> (x, -z, y)
        verts = np.stack([verts[:, 0], -verts[:, 2], verts[:, 1]], axis=1)
    return verts, faces.astype(np.int32)


def import_mesh_file(path: str) -> tuple[np.ndarray, np.ndarray]:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return load_obj(path)
    if ext == ".ply":
        return load_ply(path)
    if ext == ".off":
        return load_off(path)
    if ext == ".stl":
        return load_stl(path)
    if ext == ".dae":
        return load_dae(path)
    if ext in (".h5", ".hdf5"):
        return load_h5_geometry(path)
    raise ValueError(f"unsupported mesh format: {ext}")


# --------------------------------------------------------------------------
# HDF5 working file (the lvr2 MeshIO channel layout, SURVEY.md §2.2)
# --------------------------------------------------------------------------

MESH_GROUP = "mesh"


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError("h5py not available") from e
    return h5py


def load_h5_geometry(path: str, part: str = MESH_GROUP) -> tuple[np.ndarray, np.ndarray]:
    with _h5py().File(path, "r") as f:
        g = f[part]
        verts = np.asarray(g["vertices"], np.float32)
        faces = np.asarray(g["faces"], np.int32)
    return verts, faces


def save_working_file(
    path: str,
    mesh: MeshArrays,
    channels: dict[str, np.ndarray] | None = None,
    part: str = MESH_GROUP,
) -> None:
    """Persist geometry + cached artifacts + named per-layer channels --
    the `writeLayers` / save_map surface (mesh_map.cpp:141-146, 1199-1239)."""
    with _h5py().File(path, "a") as f:
        if part in f:
            del f[part]
        g = f.create_group(part)
        g.create_dataset("vertices", data=host_array(mesh, "vertices"))
        g.create_dataset("faces", data=host_array(mesh, "faces"))
        g.create_dataset("face_normals", data=host_array(mesh, "face_normals"))
        g.create_dataset("vertex_normals", data=host_array(mesh, "vertex_normals"))
        g.create_dataset("edge_distances", data=host_array(mesh, "edge_dist"))
        ch = g.require_group("channels")
        for name, data in (channels or {}).items():
            if name in ch:
                del ch[name]
            ch.create_dataset(name, data=np.asarray(data))


def load_channel(path: str, name: str, part: str = MESH_GROUP) -> np.ndarray | None:
    """readLayer equivalent: a cached per-layer cost channel (e.g.
    height_diff_layer.cpp:49-96), or None (also without h5py)."""
    try:
        h5py = _h5py()
    except RuntimeError:
        return None
    if not os.path.exists(path):
        return None
    with h5py.File(path, "r") as f:
        key = f"{part}/channels/{name}"
        if key in f:
            return np.asarray(f[key])
    return None


def read_map(
    mesh_file: str,
    working_file: str | None = None,
    part: str = MESH_GROUP,
    *,
    device=None,
) -> MeshArrays:
    """The MeshMap::readMap flow (mesh_map.cpp:149-310): if a working file
    exists, load from it; otherwise import the source mesh, build the CSR
    bundle (incl. non-manifold cleanup) on `device` (default: the card),
    and persist the working file."""
    if working_file and os.path.exists(working_file):
        verts, faces = load_h5_geometry(working_file, part)
        return build_mesh(verts, faces, device=device)
    verts, faces = import_mesh_file(mesh_file)
    mesh = build_mesh(verts, faces, device=device)
    if working_file:
        save_working_file(working_file, mesh, part=part)
    return mesh
