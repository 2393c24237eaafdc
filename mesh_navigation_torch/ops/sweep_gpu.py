"""Fused offset-shift relaxation sweep (port of mesh_navigation_tpu/ops/pallas_sweep.py).

The structured solver's sweep is K shifted adds + mins over the tile-padded
[T + Vp + T, B] label matrix (ops/structured.py): each tile of T rows is
relaxed `n_inner` times against its neighbour tiles as they were at the
sweep's input. `fused_sweep` launches csrc/fused_sweep.cu for a CUDA tensor
and runs `_fused_sweep_plain`, the plain PyTorch version, for a CPU tensor.
Both write a buffer apart from their input, and agree bit for bit: every
value is one add and a min, in f32 or, for a bfloat16 matrix and planes, in
bfloat16 (the f32 sum of two bfloat16 values rounded to nearest-even).
"""

from __future__ import annotations

import ctypes

import torch

from mesh_navigation_torch.ops import kernels

INF = float("inf")
# the plain version relaxes tiles in chunks of about this many window elements
_CHUNK_ELEMS = 1 << 26
# csrc/fused_sweep.cu FS_NO_FIT: no lane group's window fits in shared memory
_NO_FIT = -1


def _check_args(dist_padded, planes, offsets, tile, n_inner, out) -> None:
    K, Vp = planes.shape
    if len(offsets) != K:
        raise ValueError(f"fused_sweep: {len(offsets)} offsets for {K} planes")
    if tile < 1 or Vp % tile:
        raise ValueError(f"fused_sweep: Vp={Vp} is not a multiple of the tile {tile}")
    if offsets and max(abs(int(o)) for o in offsets) > tile:
        raise ValueError(f"fused_sweep: an offset of {offsets} exceeds the tile {tile}")
    if dist_padded.dim() != 2 or dist_padded.shape[0] != Vp + 2 * tile:
        raise ValueError(f"fused_sweep: dist_padded {tuple(dist_padded.shape)} is not "
                         f"[tile + Vp + tile, B] for Vp={Vp}, tile={tile}")
    if n_inner < 0:
        raise ValueError(f"fused_sweep: n_inner={n_inner}")
    if out is not None and (out.shape != dist_padded.shape or out.dtype != dist_padded.dtype
                            or not out.is_contiguous() or out.device != dist_padded.device
                            or out.data_ptr() == dist_padded.data_ptr()):
        raise ValueError("fused_sweep: out must be a contiguous buffer of the input's shape "
                         "and type, apart from the input")


def _fused_sweep_plain(
    dist_padded: torch.Tensor,   # [T + Vp + T, B]
    planes: torch.Tensor,        # [K, Vp]
    offsets: tuple[int, ...],
    tile: int,
    n_inner: int = 1,
    *,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of one fused sweep (_sweep_kernel, pallas_sweep.py:
    40-54): per tile, `window = [prev, centre, next]`, then n_inner times
    `best = min(centre, min_k window[T + off_k : 2T + off_k] + planes[k])`
    with the centre replaced by best. Tiles go in chunks so the [n, 3T, B]
    windows stay near _CHUNK_ELEMS elements. Returns `out` (a new matrix when None)
    with +inf end tiles."""
    _check_args(dist_padded, planes, offsets, tile, n_inner, out)
    T = tile
    K, Vp = planes.shape
    B = dist_padded.shape[1]
    n_tiles = Vp // T
    if out is None:
        out = torch.empty_like(dist_padded)
    out[:T] = INF
    out[T + Vp:] = INF
    tiles_per_chunk = max(1, _CHUNK_ELEMS // (3 * T * B))
    for t0 in range(0, n_tiles, tiles_per_chunk):
        t1 = min(t0 + tiles_per_chunk, n_tiles)
        n = t1 - t0
        prev = dist_padded[t0 * T:t1 * T].view(n, T, B)
        cur = dist_padded[(t0 + 1) * T:(t1 + 1) * T].view(n, T, B)
        nxt = dist_padded[(t0 + 2) * T:(t1 + 2) * T].view(n, T, B)
        w = planes[:, t0 * T:t1 * T].reshape(K, n, T, 1)
        for _ in range(n_inner):
            window = torch.cat([prev, cur, nxt], dim=1)
            best = cur
            for k, off in enumerate(offsets):
                best = torch.minimum(best, window[:, T + off:2 * T + off] + w[k])
            cur = best
        out[(t0 + 1) * T:(t1 + 1) * T].view(n, T, B).copy_(cur)
    return out


def fused_sweep(
    dist_padded: torch.Tensor,   # [T + Vp + T, B] f32 or bf16, one +inf tile each end
    planes: torch.Tensor,        # [K, Vp] per-class weights of the same type (+inf = no edge)
    offsets: tuple[int, ...],
    tile: int = 512,
    n_inner: int = 1,
    *,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """n_inner relaxations of every tile per pass over the matrix (fused_sweep,
    pallas_sweep.py:57-84). Asserts `Vp % tile == 0` and `max|off| <= tile`;
    returns `out` (a new matrix when None, never `dist_padded` itself) with
    +inf end tiles. CPU tensors run _fused_sweep_plain; CUDA tensors launch
    csrc/fused_sweep.cu or raise."""
    offsets = tuple(int(o) for o in offsets)
    if dist_padded.device.type == "cpu":
        return _fused_sweep_plain(dist_padded, planes, offsets, tile, n_inner, out=out)
    if dist_padded.device.type != "cuda":
        raise ValueError(f"fused_sweep: unsupported device {dist_padded.device}")
    _check_args(dist_padded, planes, offsets, tile, n_inner, out)
    dtype = dist_padded.dtype
    for name, t in (("dist_padded", dist_padded), ("planes", planes)):
        if (t.dtype != dtype or dtype not in (torch.float32, torch.bfloat16)
                or not t.is_contiguous() or t.device != dist_padded.device):
            raise ValueError(f"fused_sweep: {name} must be contiguous f32 or bfloat16, of one "
                             f"type with the matrix, on {dist_padded.device}")
    K, Vp = planes.shape
    B = dist_padded.shape[1]
    if out is None:
        out = torch.empty_like(dist_padded)
    out[:tile] = INF
    out[tile + Vp:] = INF
    offs = (ctypes.c_int * max(K, 1))(*offsets)
    stream = torch.cuda.current_stream(dist_padded.device).cuda_stream
    bf16 = dtype == torch.bfloat16
    err = kernels.launcher("fused_sweep")(
        dist_padded.data_ptr(), int(bf16), planes.data_ptr(), out.data_ptr(),
        ctypes.addressof(offs), K, Vp, tile, B, n_inner, stream,
    )
    if err == _NO_FIT:
        raise ValueError(f"fused_sweep: the window of tile {tile} and offsets {offsets} "
                         "does not fit in a block's shared memory")
    kernels.check("fused_sweep", err)
    kernels.LAUNCHES["fused_sweep"] += 1
    if bf16:
        kernels.LAUNCHES["fused_sweep_bf16"] += 1
    return out


def sweep_loop(
    dist_padded: torch.Tensor,
    planes: torch.Tensor,
    offsets: tuple[int, ...],
    n_sweeps: int,
    tile: int = 512,
) -> torch.Tensor:
    """n_sweeps fused sweeps (n_inner 1) between two buffers (sweep_loop,
    pallas_sweep.py:87-97). Returns a new matrix; the input is left as it
    was."""
    cur = dist_padded.clone()
    spare = torch.empty_like(dist_padded)
    for _ in range(n_sweeps):
        new = fused_sweep(cur, planes, offsets, tile=tile, out=spare)
        cur, spare = new, cur
    return cur
