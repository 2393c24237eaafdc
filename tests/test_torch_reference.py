"""Reference meshes for the port's parity tests, from the reference's native
core only.

The reference's build_mesh falls back to numpy on any failure of its native
path, and the numpy builder numbers edges in another order. Its loader
compiles libmeshcore.so in place with no lock and gives up for the life of
the process once a load fails. With several test workers, one can load
another's half-written library and then build every reference mesh with the
fallback, so exact-table parity tests fail at random. `reference_build_mesh`
serialises the load under a file lock, retries a loader that gave up, and
builds with use_native=True, which raises instead of falling back.

Other tests/test_torch_*.py files import the helper from here."""

import fcntl
import os
import tempfile
import time

import numpy as np
import pytest

from mesh_navigation_tpu import native as ref_native
from mesh_navigation_tpu.mesh import build_mesh as _ref_build_mesh
from mesh_navigation_tpu.mesh import reorder as _ref_reorder
from mesh_navigation_tpu.mesh import synthetic

from mesh_navigation_torch.mesh.arrays import build_mesh

_LOCK = os.path.join(tempfile.gettempdir(), "mesh_navigation_tpu_meshcore.lock")
_ATTEMPTS, _WAIT_S = 40, 0.25     # up to 10 s for another process's build


def _load_reference_native() -> None:
    for _ in range(_ATTEMPTS):
        if ref_native._lib is None and ref_native._tried:
            ref_native._tried = False       # the loader gave up: let it try again
        try:
            if ref_native.get_lib() is not None:
                return
        except OSError:                     # a library another process is writing
            pass
        time.sleep(_WAIT_S)
    raise RuntimeError("the reference's native meshcore did not load")


def reference_build_mesh(v, f, *, reorder: bool = False):
    """The reference's MeshArrays built by its native core (band-reordered
    first with `reorder`), or an error; never the numpy fallback."""
    with open(_LOCK, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            _load_reference_native()
            if reorder:
                return _ref_reorder.build_reordered_mesh(v, f, use_native=True)
            return _ref_build_mesh(v, f, use_native=True)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _mesh(kind):
    if kind == "terrain16":
        return synthetic.terrain_mesh(16, 16, spacing=0.5, hills=1.5, roughness=0.02, seed=3)
    return synthetic.irregular_terrain_mesh(32, 32, spacing=0.5, hills=1.0, seed=4)


@pytest.mark.parametrize("kind", ["terrain16", "irregular32"])
def test_reference_mesh_after_the_loader_gave_up(kind):
    v, f = _mesh(kind)
    saved = ref_native._lib, ref_native._tried
    ref_native._lib, ref_native._tried = None, True      # a failed load, as a racing worker sees it
    try:
        jm = reference_build_mesh(v, f)
    finally:
        if ref_native._lib is None:
            ref_native._lib, ref_native._tried = saved
    tm = build_mesh(v, f, device="cpu")
    np.testing.assert_array_equal(np.asarray(jm.edges), tm.edges.numpy())
    np.testing.assert_array_equal(np.asarray(jm.face_edges), tm.face_edges.numpy())


def test_numpy_fallback_numbers_edges_otherwise():
    """What the helper guards against: the reference's numpy builder gives
    the same edges in another order, which fails exact-table parity."""
    v, f = _mesh("terrain16")
    fallback = _ref_build_mesh(v, f, use_native=False)
    tm = build_mesh(v, f, device="cpu")
    a, b = np.asarray(fallback.edges), tm.edges.numpy()
    assert not np.array_equal(a, b)
    assert {tuple(e) for e in a} == {tuple(e) for e in b}
